"""ViT / TransUnet config registry (counterpart of
unet_torch_tpu/models/transunet/configs.py, which mirrors the reference's
vit_seg_configs.py).

Plain dataclasses with the same keys and values as the JAX package's
ml_collections entries, so that the port needs neither ml_collections nor
the JAX package. A key that an entry of the JAX registry does not set is
None here (for example `pretrained_path` of `testing`, and `resnet` of the
non-hybrid configs). `patches.grid` is None for a non-hybrid ViT.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Patches:
    size: tuple = (16, 16)
    grid: tuple | None = None


@dataclasses.dataclass
class TransformerConfig:
    mlp_dim: int = 3072
    num_heads: int = 12
    num_layers: int = 12
    attention_dropout_rate: float = 0.0
    dropout_rate: float = 0.1


@dataclasses.dataclass
class ResNetConfig:
    num_layers: tuple = (3, 4, 9)
    width_factor: int = 1


@dataclasses.dataclass
class ViTConfig:
    patches: Patches = dataclasses.field(default_factory=Patches)
    hidden_size: int = 768
    transformer: TransformerConfig = dataclasses.field(
        default_factory=TransformerConfig)
    classifier: str = "seg"
    representation_size: int | None = None
    resnet_pretrained_path: str | None = None
    pretrained_path: str | None = None
    patch_size: int | None = None
    decoder_channels: tuple = (256, 128, 64, 16)
    n_classes: int = 2
    n_skip: int = 0
    activation: str = "softmax"
    resnet: ResNetConfig | None = None
    skip_channels: list | None = None


_VIT_CKPT = "./model/vit_checkpoint/imagenet21k/"


def get_b16_config() -> ViTConfig:
    return ViTConfig(pretrained_path=_VIT_CKPT + "ViT-B_16.npz", patch_size=16)


def get_testing() -> ViTConfig:
    return ViTConfig(
        hidden_size=1,
        transformer=TransformerConfig(mlp_dim=1, num_heads=1, num_layers=1),
        classifier="token")


def get_r50_b16_config() -> ViTConfig:
    c = get_b16_config()
    c.patches.grid = (16, 16)
    c.resnet = ResNetConfig()
    c.pretrained_path = _VIT_CKPT + "R50+ViT-B_16.npz"
    c.skip_channels = [512, 256, 64, 16]
    c.n_skip = 3
    return c


def get_b32_config() -> ViTConfig:
    c = get_b16_config()
    c.patches.size = (32, 32)
    c.pretrained_path = _VIT_CKPT + "ViT-B_32.npz"
    return c


def get_l16_config() -> ViTConfig:
    c = get_b16_config()
    c.hidden_size = 1024
    c.transformer = TransformerConfig(mlp_dim=4096, num_heads=16,
                                      num_layers=24)
    c.pretrained_path = _VIT_CKPT + "ViT-L_16.npz"
    return c


def get_r50_l16_config() -> ViTConfig:
    c = get_l16_config()
    c.patches.grid = (16, 16)
    c.resnet = ResNetConfig()
    c.skip_channels = [512, 256, 64, 16]
    c.n_skip = 3
    return c


def get_l32_config() -> ViTConfig:
    c = get_l16_config()
    c.patches.size = (32, 32)
    return c


def get_h14_config() -> ViTConfig:
    c = get_b16_config()
    c.patches.size = (14, 14)
    c.hidden_size = 1280
    c.transformer = TransformerConfig(mlp_dim=5120, num_heads=16,
                                      num_layers=32)
    c.classifier = "token"
    return c


CONFIGS = {
    "ViT-B_16": get_b16_config(),
    "ViT-B_32": get_b32_config(),
    "ViT-L_16": get_l16_config(),
    "ViT-L_32": get_l32_config(),
    "ViT-H_14": get_h14_config(),
    "R50-ViT-B_16": get_r50_b16_config(),
    "R50-ViT-L_16": get_r50_l16_config(),
    "testing": get_testing(),
}
