"""The port's TransUnet (unet_torch_tpu_torch/models/transunet) against the JAX
package's: the config registry, the ResNetV2 backbone, the align-corners
upsample, the weights bridge and the eval forward in f32 and in bf16, at a
small size (hidden 16, 2 layers, 2 heads, ResNet (1, 1, 1), 64x64, as
tests/test_transunet.py builds it)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_torch_tpu.ckpt.torch_import import load_torch_transunet
from unet_torch_tpu.models.transunet import CONFIGS as JAX_CONFIGS
from unet_torch_tpu.models.transunet import ResNetV2 as JaxResNetV2
from unet_torch_tpu.models.transunet import VisionTransformer as JaxViT
from unet_torch_tpu.models.transunet import bilinear_upsample_2x as jax_up
from unet_torch_tpu.models.transunet.vit import _tail_fold_factor
from unet_torch_tpu_torch.ckpt.bridge import transunet_state_dict_from_flax
from unet_torch_tpu_torch.eval.reports import make_predict_fn
from unet_torch_tpu_torch.models.transunet.configs import CONFIGS
from unet_torch_tpu_torch.models.transunet.resnetv2 import ResNetV2
from unet_torch_tpu_torch.models.transunet.vit import (
    VisionTransformer,
    VisionTransformerMultitask,
    VisionTransformerMultitaskEM,
    bilinear_upsample_2x,
    build_transunet,
)

IMG = 64


def small_config(configs, decoder_last=16, hybrid=True):
    """tests/test_transunet.py::small_r50_config, from either registry."""
    c = copy.deepcopy(configs["R50-ViT-B_16" if hybrid else "ViT-B_16"])
    c.hidden_size = 16
    c.transformer.mlp_dim = 32
    c.transformer.num_layers = 2
    c.transformer.num_heads = 2
    c.n_classes = 3
    c.n_skip = 3
    c.decoder_channels = (256, 128, 64, decoder_last)
    if hybrid:
        c.patches.grid = (IMG // 16, IMG // 16)
        c.resnet.num_layers = (1, 1, 1)
    return c


def _seeded_stats(rng, batch_stats):
    """BN running statistics away from mean 0 / var 1, which would make the
    folding trivial."""
    def stat(path, a):
        if path[-1].key == "var":
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        return (rng.randn(*a.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        stat, jax.tree_util.tree_map(np.asarray, batch_stats))


def _jax_vit(config, channels=3, seed=0):
    """A JAX VisionTransformer, its input and its trees. Every norm scale,
    bias and the position embeddings are drawn away from flax's 1 / 0 init,
    and the BN running statistics away from mean 0 / var 1, which would hide
    a swapped or dropped parameter."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, IMG, IMG, channels).astype(np.float32)
    model = JaxViT(config, img_size=IMG, num_classes=3)
    variables = model.init(jax.random.key(seed), jnp.asarray(x), train=False)

    def draw(path, a):
        a = np.asarray(a)
        if path[-1].key == "scale":
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        if path[-1].key in ("bias", "position_embeddings"):
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(draw, variables["params"])
    return model, x, params, _seeded_stats(rng, variables["batch_stats"])


def test_config_registry_matches_jax():
    assert set(CONFIGS) == set(JAX_CONFIGS)
    for name, jax_cfg in JAX_CONFIGS.items():
        ref = jax_cfg.to_dict()
        ours = dataclasses.asdict(CONFIGS[name])
        for key, value in ours.items():
            if key not in ref:
                # a key this entry of the JAX registry does not set
                assert value is None, (name, key)
        for key, value in ref.items():
            assert key in ours, (name, key)
            if isinstance(value, dict):
                theirs = {k: v for k, v in ours[key].items()
                          if k in value or v is not None}
                assert theirs == value, (name, key)
            else:
                assert ours[key] == value, (name, key)


def test_resnetv2_features_match_jax():
    _, x, params, batch_stats = _jax_vit(small_config(JAX_CONFIGS), seed=1)
    hybrid = params["transformer"]["embeddings"]["hybrid_model"]
    ref_x, ref_feats = JaxResNetV2(block_units=(1, 1, 1)).apply(
        {"params": hybrid}, jnp.asarray(x))
    sd = transunet_state_dict_from_flax(params, batch_stats)
    prefix = "transformer.embeddings.hybrid_model."
    port = ResNetV2((1, 1, 1))
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                          if k.startswith(prefix)}, strict=True)
    with torch.inference_mode():
        out, feats = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    # f32 convs and GroupNorm in another summation order
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_x), atol=1e-4, rtol=1e-4)
    assert len(feats) == len(ref_feats) == 3
    for ours, ref in zip(feats, ref_feats):
        assert ours.shape[2:] == ref.shape[1:3]
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hw", [(7, 9), (1, 1), (8, 8)])
def test_bilinear_upsample_matches_jax(hw):
    x = np.random.RandomState(2).randn(2, *hw, 5).astype(np.float32)
    ref = np.asarray(jax_up(jnp.asarray(x)))
    ours = bilinear_upsample_2x(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    # both interpolate between the same two f32 neighbours
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_bridge_roundtrips_through_load_torch_transunet():
    _, _, params, batch_stats = _jax_vit(small_config(JAX_CONFIGS))
    sd = transunet_state_dict_from_flax(params, batch_stats)
    zeros = lambda t: jax.tree_util.tree_map(np.zeros_like, t)  # noqa: E731
    p2, b2 = load_torch_transunet(sd, zeros(params), zeros(batch_stats))
    for ours, ref in ((p2, params), (b2, batch_stats)):
        assert (jax.tree_util.tree_structure(ours)
                == jax.tree_util.tree_structure(ref))
        for a, b in zip(jax.tree_util.tree_leaves(ours),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, b)
    # the reference's names are the port's: a strict load takes every key
    VisionTransformer(small_config(CONFIGS), IMG, 3).load_state_dict(
        sd, strict=True)


@pytest.mark.parametrize("decoder_last,channels,hybrid", [
    (16, 3, True),   # the served layout: JAX folds the decoder tail (x8)
    (24, 3, True),   # 128 % 24 != 0: JAX runs the tail unfolded
    (16, 1, True),   # gray input, repeated to RGB
    (16, 3, False),  # plain ViT patches, no skips
])
def test_eval_forward_matches_jax(decoder_last, channels, hybrid):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    jax_cfg = small_config(JAX_CONFIGS, decoder_last, hybrid)
    assert _tail_fold_factor(jax_cfg, IMG) == (8 if decoder_last == 16
                                               else 1)
    model, x, params, batch_stats = _jax_vit(jax_cfg, channels)
    ref = np.asarray(model.apply({"params": params,
                                  "batch_stats": batch_stats},
                                 jnp.asarray(x), train=False))
    port = VisionTransformer(small_config(CONFIGS, decoder_last, hybrid),
                             IMG, 3)
    port.load_state_dict(transunet_state_dict_from_flax(params, batch_stats),
                         strict=True)
    port.eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, IMG, IMG, 3)
    assert out.dtype == torch.float32
    # the bound of tests/test_torch_port_unet.py (JAX against torch, f32)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("decoder_last", [16, 24])
def test_bf16_eval_forward_matches_jax_bf16(decoder_last):
    """The bf16 eval forward through make_predict_fn against the JAX
    VisionTransformer with dtype=bfloat16, same weights and input, for JAX's
    folded and unfolded decoder tails. The two round at other places (JAX's
    decoder BN applies its affine in bf16 after a bf16 conv, the port's fused
    conv in f32, rounding once), so they are held to each other within 8
    bf16 ulps of the logits' peak (read: 2.7 and 3.0), and the port's
    distance from the f32 forward to twice JAX's own plus an ulp (read: 2.7
    against 2.4 and 1.9 against 2.0 ulps): a difference beyond rounding would
    break the second bound."""
    jax_cfg = small_config(JAX_CONFIGS, decoder_last, True)
    model, x, params, batch_stats = _jax_vit(jax_cfg, 3)
    variables = {"params": params, "batch_stats": batch_stats}
    ref32 = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    ref16 = JaxViT(jax_cfg, img_size=IMG, num_classes=3,
                   dtype=jnp.bfloat16).apply(variables, jnp.asarray(x),
                                             train=False)
    assert ref16.dtype == jnp.bfloat16
    ref16 = np.asarray(ref16.astype(jnp.float32))
    port = VisionTransformer(small_config(CONFIGS, decoder_last, True), IMG,
                             3)
    port.load_state_dict(transunet_state_dict_from_flax(params, batch_stats),
                         strict=True)
    predict = make_predict_fn(port.to(torch.bfloat16), "cpu", torch.bfloat16)
    out = predict(x)
    assert out.dtype == torch.bfloat16 and out.shape == ref16.shape
    out = out.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref32).max())) - 7)
    assert np.abs(out - ref16).max() <= 8 * ulp
    assert (np.abs(out - ref32).max()
            <= 2 * np.abs(ref16 - ref32).max() + ulp)


def test_build_transunet_contract():
    with pytest.warns(UserWarning, match="fold"):
        model = build_transunet("TransUnet", img_size=IMG, num_classes=4,
                                fold=True)
    emb = model.transformer.embeddings
    assert emb.position_embeddings.shape == (1, (IMG // 16) ** 2, 768)
    assert len(model.transformer.encoder.layer) == 12
    assert [len(b) for b in emb.hybrid_model.body] == [3, 4, 9]
    assert model.segmentation_head[0].out_channels == 4
    assert CONFIGS["R50-ViT-B_16"].patches.grid == (16, 16)  # not mutated
    # the JAX package's build_transunet's classes, heads and names
    for mt, cls, heads in (
            ("regression_t", VisionTransformer, [""]),
            ("multi_task_regTU", VisionTransformerMultitask, ["1", "2"]),
            ("multitask_em", VisionTransformerMultitaskEM,
             [str(i) for i in range(1, 7)])):
        model = build_transunet(mt, img_size=IMG, num_classes=3)
        assert type(model) is cls
        assert {n.split(".")[0] for n in model.state_dict()} == {
            "transformer", *(f"decoder{h}" for h in heads),
            *(f"segmentation_head{h}" for h in heads)}
        assert hasattr(model, "add_log_vars") == (mt == "multi_task_regTU")
    with pytest.raises(ValueError):
        build_transunet("nope", img_size=IMG, num_classes=3)
    vis = VisionTransformer(small_config(CONFIGS), IMG, 3, vis=True).eval()
    assert vis.attn_weights == [None, None]  # no forward yet
    with torch.inference_mode():
        vis(torch.zeros(1, IMG, IMG, 3))
    assert [w.shape for w in vis.attn_weights] == [(1, 2, 16, 16)] * 2
