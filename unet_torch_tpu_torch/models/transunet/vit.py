"""TransUnet: ViT(-hybrid) encoder + cup decoder (counterpart of
unet_torch_tpu/models/transunet/vit.py, which mirrors the reference's
vit_seg_modeling.py): the eval and train forwards of the three TransUnet
models.

  Attention          fused QKV projection, the attention kernel (eval:
                     fused_attention; train: dropout_flash_attention, the
                     train forward and backward kernels), out projection,
                     dropout at attention_dropout_rate
  Mlp                fc1, exact GELU, fc2, dropout
  Block / Encoder    pre-LN blocks (LayerNorm eps 1e-6), final LayerNorm
  Embeddings         ResNetV2 hybrid + 1x1 patch conv (or plain patches),
                     learned position embeddings
  Conv2dReLU         conv3x3 (no bias) + BN (eps 1e-5) + ReLU: in eval one
                     fused_conv3x3_bn_relu call (the Hopper kernel on a card)
  DecoderCup         tokens -> (B, h, w, hidden) -> conv_more -> DecoderBlocks
                     (align-corners bilinear 2x up, concat skip, 2 Conv2dReLU)
  SegmentationHead   conv3x3 with bias
  VisionTransformer  gray -> RGB repeat, encoder, decoder, head
                     (`TransUnet`, `regression_t`); `vis=True` keeps the
                     attention probabilities
  ...Multitask(EM)   the same encoder, then 2 (6) decoders and heads
                     (`multi_task_regTU`, `multitask_em`)

The models take NHWC input (B, H, W, C) and return NHWC logits (a tuple of
them for the multi-head ones), as the JAX models do. The ResNetV2 and the
encoder run on NCHW tensors in channels_last memory; the decoders run on
NHWC tensors, the fused conv kernel's layout. Parameters stay f32 and each
layer computes in its input's dtype, except the ViT's residual stream: as
in the JAX model, the f32 position embeddings promote it to f32, so twelve
layers of updates are summed in f32; each block's LayerNorm output, and
so its products, are in the compute dtype (the image's), and so is the
encoder's output.

In train mode every dropout draws from the generator that the train step
binds (nn/dropout.py::set_dropout_generator), as the JAX model draws from
the step's `rng`; Conv2dReLU runs torch's conv (weight in the input's
dtype), BN (f32 statistics) and ReLU.

Under tensor parallelism (parallel/tensor.py::shard_model_tp) `query`,
`key`, `value` and `fc1` hold a rank's share of the output features and
`out` and `fc2` its share of the input features: each rank runs the
attention on its num_heads / model heads (at the same head width), with the
mask of those heads of the whole batch (`kernels/attention.py` offsets).

On a spatial mesh (parallel/spatial.py::spatialize) rank (d, m) holds its
batch rows and its strip of the image's rows. The ResNetV2 runs on the
strip (resnetv2.py); the tokens of a strip are its rows of the patch grid,
contiguous in the row-major sequence, so it adds its rows of the position
embeddings, and every token-wise layer (LayerNorm, MLP, projections) is
local. Attention keeps the strip's queries and gathers the keys and values
of every strip (core/dist.py::all_gather_dim, whose backward sums the
ranks' partial dk and dv): the eval kernel at Nq = N / M and Nk = N, and
the train kernels with the mask's query-row offset q_off = m N / M. The
decoder reshapes a strip's tokens to (B, N / M / w, w, hidden), reads its
neighbours' rows before every 3x3 conv (the fused conv on the haloed strip
in eval, torch's conv in train, whose BN statistics spatialize sums over
the world group) and upsamples from the global row positions
(nn/strips.py::upsample_rows_2x). With `vis` a strip keeps its query
rows of the probabilities (Attention).

The JAX package's W-folded decoder tail (FoldedDecoderTail, _FoldedHeadConv,
_tail_fold_factor) is a TPU lane-padding workaround over the same parameters
and is not carried over. Modules carry the reference's state_dict names, so
`ckpt/bridge.py::transunet_state_dict_from_flax` output loads strictly.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from unet_torch_tpu_torch.kernels.attention import (
    attention_probs,
    dropout_flash_attention,
    fused_attention,
)
from unet_torch_tpu_torch.kernels.fused_conv import (
    fold_bn,
    fused_conv3x3_bn_relu,
)
from unet_torch_tpu_torch.models.transunet.configs import CONFIGS
from unet_torch_tpu_torch.models.transunet.resnetv2 import ResNetV2
from unet_torch_tpu_torch.models.unet import (
    UNetMultitask,
    ignore_tpu_options,
)
from unet_torch_tpu_torch.core.dist import (
    all_gather_dim,
    copy_to_group,
    exchange_rows,
)
from unet_torch_tpu_torch.nn.dropout import Dropout, MeshBound
from unet_torch_tpu_torch.nn.strips import strip_conv2d, upsample_rows_2x



def bilinear_upsample_2x(x):
    """NHWC 2x bilinear upsampling with align_corners=True (the reference's
    UpsamplingBilinear2d)."""
    _, h, w, _ = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * h, 2 * w),
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class Attention(MeshBound, nn.Module):
    """Multi-head self-attention. q, k and v come from one product with the
    three weights stacked; the heads go through the attention kernels as
    (B, heads, N, d).

    In train mode with autograd recording, `dropout_flash_attention` runs at
    `attention_dropout_rate`; with a rate above 0 each call draws its mask
    seed from the bound generator (one host read per layer and step: no
    registry config sets the rate), at rate 0 it runs no hash. Otherwise
    `fused_attention` runs the eval kernel. The out projection's dropout
    runs at the same rate, as in the JAX model.

    With `vis` every mode runs the plain version instead, as the JAX model
    routes `vis` through its einsum attention: the f32 probabilities
    (`attention_probs`) are kept, detached, as `.weights`, then go through
    the dropout at `attention_dropout_rate` in train mode and multiply v.
    No kernel can return them. Under a tensor mesh `.weights` gathers
    every head over the model group, so that it equals one process's;
    under a spatial mesh it holds the strip's query rows against every
    key, (B, heads, N / M, N), as the strip's logits are the strip's: the
    whole array is `all_gather_dim(weights, strip_group, 2)`.

    With a mesh bound (nn/dropout.py::set_mesh) the rows and heads are a
    rank's share: its heads are the product's width over the head width,
    and the kernels hash the mask of its place in the whole batch. Under a
    spatial mesh the tokens are the rank's strip: k and v are gathered
    from every strip, and the mask's query rows start at the strip's
    first token."""

    def __init__(self, hidden_size: int, num_heads: int,
                 attention_dropout_rate: float = 0.0, vis: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.rate = attention_dropout_rate
        self.vis = vis
        self.weights = None
        self.query = Linear(hidden_size, hidden_size)
        self.key = Linear(hidden_size, hidden_size)
        self.value = Linear(hidden_size, hidden_size)
        self.out = Linear(hidden_size, hidden_size)
        self.dropout = Dropout(attention_dropout_rate)

    def offsets(self, b: int, heads: int, n: int):
        """The kernels' (b_off, h_off, h_total, q_off) of this rank's b rows,
        heads and n query tokens, or None in one process."""
        mesh = self.mesh
        if mesh is None:
            return None
        if mesh.role == "spatial":
            return (mesh.d * b, 0, heads, mesh.m * n)
        return (mesh.d * b, mesh.m * heads, heads * mesh.model, 0)

    def forward(self, x):
        b, n, _ = x.shape
        d = self.head_dim
        mesh, strips = self.mesh, self.strip_group
        tp = mesh is not None and mesh.role == "tensor"
        x = copy_to_group(x, mesh.model_group if tp else None)
        w = torch.cat([self.query.weight, self.key.weight, self.value.weight])
        bias = torch.cat([self.query.bias, self.key.bias, self.value.bias])
        qkv = F.linear(x, w.to(x.dtype), bias.to(x.dtype))
        heads = qkv.shape[-1] // (3 * d)
        # (B, N, 3, heads, d) -> (3, B, heads, N, d): q, k, v contiguous
        qkv = qkv.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).contiguous()
        q = qkv[0]
        # every strip's keys and values, in one collective
        k, v = all_gather_dim(qkv[1:], strips, 3)
        scale = 1.0 / math.sqrt(d)
        if self.vis:
            p = attention_probs(q, k, scale)
            # every head's, in the order `offsets` lays them out
            self.weights = all_gather_dim(p.detach(),
                                          mesh.model_group if tp else None, 1)
            p = self.dropout(p, model_dim=1, spatial_dim=2).to(v.dtype)
            ctx = torch.einsum("bhqk,bhkd->bhqd", p.float(),
                               v.float()).to(q.dtype)
        elif self.training and torch.is_grad_enabled():
            seed = 0
            if self.rate > 0.0:
                gen = self.dropout.generator
                if gen is None:
                    raise RuntimeError("train-mode attention dropout needs a "
                                       "generator: call set_dropout_generator")
                seed = int(torch.randint(0, 2 ** 32, (), generator=gen,
                                         device=gen.device))
            ctx = dropout_flash_attention(q, k, v, seed, scale, self.rate,
                                          self.offsets(b, heads, n))
        else:
            ctx = fused_attention(q, k, v, scale=scale)
        out = self.out(ctx.permute(0, 2, 1, 3).reshape(b, n, heads * d))
        return self.dropout(out, spatial_dim=1)


class Mlp(nn.Module):
    def __init__(self, hidden_size: int, mlp_dim: int, dropout_rate: float):
        super().__init__()
        self.fc1 = Linear(hidden_size, mlp_dim)
        self.fc2 = Linear(mlp_dim, hidden_size)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        # fc1's output is split over the model ranks under tensor
        # parallelism; the tokens over the strips under a spatial mesh
        x = self.dropout(F.gelu(self.fc1(x)), model_dim=-1, spatial_dim=1)
        return self.dropout(self.fc2(x), spatial_dim=1)


class Block(nn.Module):
    def __init__(self, config, vis: bool = False):
        super().__init__()
        hidden, t = config.hidden_size, config.transformer
        self.attention_norm = LayerNorm(hidden, eps=1e-6)
        self.ffn_norm = LayerNorm(hidden, eps=1e-6)
        self.ffn = Mlp(hidden, t.mlp_dim, t.dropout_rate)
        self.attn = Attention(hidden, t.num_heads, t.attention_dropout_rate,
                              vis)

    def forward(self, x, dtype):
        """x: the residual stream (f32 under bf16); dtype: the compute
        dtype of the LayerNorm outputs and the products."""
        x = x + self.attn(self.attention_norm(x).to(dtype))
        return x + self.ffn(self.ffn_norm(x).to(dtype))


class Encoder(nn.Module):
    def __init__(self, config, vis: bool = False):
        super().__init__()
        self.layer = nn.ModuleList(
            Block(config, vis) for _ in range(config.transformer.num_layers))
        self.encoder_norm = LayerNorm(config.hidden_size, eps=1e-6)

    def forward(self, x, dtype):
        for block in self.layer:
            x = block(x, dtype)
        return self.encoder_norm(x).to(dtype)


class Embeddings(MeshBound, nn.Module):
    """NCHW image -> ((B, n_patches, hidden) tokens, ResNetV2 skips or None);
    on a strip, its tokens (module docstring)."""

    def __init__(self, config, img_size: int):
        super().__init__()
        grid = config.patches.grid
        if grid is not None:
            patch = (img_size // 16 // grid[0], img_size // 16 // grid[1])
            n_patches = ((img_size // (16 * patch[0]))
                         * (img_size // (16 * patch[1])))
            self.hybrid_model = ResNetV2(config.resnet.num_layers,
                                         config.resnet.width_factor)
            in_channels = self.hybrid_model.width * 16
        else:
            patch = tuple(config.patches.size)
            n_patches = (img_size // patch[0]) * (img_size // patch[1])
            in_channels = 3
        self.patch_embeddings = nn.Conv2d(in_channels, config.hidden_size,
                                          patch, stride=patch)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, n_patches, config.hidden_size))
        self.dropout = Dropout(config.transformer.dropout_rate)

    def forward(self, x):
        """NCHW image -> (tokens in f32 or the image's wider dtype: the
        position embeddings promote them, as in the JAX model; skips)."""
        features = None
        if hasattr(self, "hybrid_model"):
            x, features = self.hybrid_model(x)
        pe = self.patch_embeddings
        x = F.conv2d(x, pe.weight.to(x.dtype), pe.bias.to(x.dtype),
                     stride=pe.stride)
        x = x.flatten(2).transpose(1, 2)
        pos = self.position_embeddings
        if self.strip_group is not None:
            n = x.shape[1]
            pos = pos[:, self.mesh.m * n:(self.mesh.m + 1) * n]
        return self.dropout(x + pos, spatial_dim=1), features


class Transformer(nn.Module):
    def __init__(self, config, img_size: int, vis: bool = False):
        super().__init__()
        self.embeddings = Embeddings(config, img_size)
        self.encoder = Encoder(config, vis)

    def forward(self, x):
        dtype = x.dtype
        x, features = self.embeddings(x)
        return self.encoder(x, dtype), features


class Conv2dReLU(MeshBound, nn.Sequential):
    """conv3x3 (no bias) -> BatchNorm -> ReLU on NHWC tensors, as `.0`, `.1`
    and `.2`. In eval mode BN folds its running statistics into a scale and
    bias and the three run as one fused_conv3x3_bn_relu call (the Hopper
    kernel on a CUDA tensor); in train mode they run as torch's conv (the
    weight cast to the input's dtype), BN and ReLU. The kernel is
    inference-only, so an eval-mode forward that autograd records (the
    pipelined forward's train step, whose BN keeps its running statistics
    as the JAX package's does) runs the train path's conv, BN on the
    running statistics, and ReLU. On a strip it reads its neighbours' rows
    first: the fused conv runs on the haloed strip, whose inner rows it
    keeps."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        )

    def forward(self, x):
        conv, bn = self[0], self[1]
        group = self.strip_group
        if self.training or (torch.is_grad_enabled() and (
                x.requires_grad or conv.weight.requires_grad)):
            y = strip_conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                             None, 1, 1, group)
            return F.relu(bn(y)).permute(0, 2, 3, 1)
        scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean,
                              bn.running_var, bn.eps)
        w = conv.weight.permute(2, 3, 1, 0).to(x.dtype).contiguous()
        if group is None:
            return fused_conv3x3_bn_relu(x.contiguous(), w, scale, bias)
        return fused_conv3x3_bn_relu(exchange_rows(x, group, dim=1), w, scale,
                                     bias)[:, 1:-1]


class DecoderBlock(MeshBound, nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 skip_channels: int = 0):
        super().__init__()
        self.conv1 = Conv2dReLU(in_channels + skip_channels, out_channels)
        self.conv2 = Conv2dReLU(out_channels, out_channels)

    def forward(self, x, skip=None):
        group = self.strip_group
        if group is None:
            x = bilinear_upsample_2x(x)
        else:
            x = upsample_rows_2x(x, group, self.mesh.m, self.mesh.model)
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        return self.conv2(self.conv1(x))


class DecoderCup(MeshBound, nn.Module):
    """(B, n_patches, hidden) tokens + NCHW skips -> NHWC features; on a
    strip, its tokens and skips -> its rows of the features."""

    head_channels = 512

    def __init__(self, config):
        super().__init__()
        self.n_skip = config.n_skip
        self.conv_more = Conv2dReLU(config.hidden_size, self.head_channels)
        out_channels = list(config.decoder_channels)
        in_channels = [self.head_channels] + out_channels[:-1]
        hybrid = config.patches.grid is not None
        skip_channels = [config.skip_channels[i] if hybrid and i < self.n_skip
                         else 0 for i in range(len(out_channels))]
        self.blocks = nn.ModuleList(
            DecoderBlock(i, o, s)
            for i, o, s in zip(in_channels, out_channels, skip_channels))

    def forward(self, hidden_states, features=None):
        b, n_patch, hidden = hidden_states.shape
        strips = 1 if self.strip_group is None else self.mesh.model
        w = math.isqrt(n_patch * strips)
        x = self.conv_more(hidden_states.reshape(b, n_patch // w, w, hidden))
        for i, block in enumerate(self.blocks):
            skip = None
            if features is not None and i < self.n_skip:
                skip = features[i].permute(0, 2, 3, 1)
            x = block(x, skip)
        return x


class SegmentationHead(MeshBound, nn.Sequential):
    """conv3x3 with bias on NHWC features, as `.0`."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(nn.Conv2d(in_channels, out_channels, 3, padding=1))

    def forward(self, x):
        conv = self[0]
        y = strip_conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                         conv.bias.to(x.dtype), 1, 1, self.strip_group)
        return y.permute(0, 2, 3, 1)


class _TransUnet(nn.Module):
    """The shared encoder (`transformer`), then one DecoderCup and
    SegmentationHead a head, named `decoder{s}` and `segmentation_head{s}`
    for each suffix s of `heads`, as the reference's state_dicts name
    them."""

    heads = ("",)

    def __init__(self, config, img_size: int, num_classes: int,
                 vis: bool = False, generator=None):
        super().__init__()
        self.transformer = Transformer(config, img_size, vis)
        for s in self.heads:
            setattr(self, f"decoder{s}", DecoderCup(config))
            setattr(self, f"segmentation_head{s}", SegmentationHead(
                config.decoder_channels[-1], num_classes))
        reset_parameters(self, generator)

    def forward(self, x) -> tuple:
        """NHWC input (C = 3, or 1: repeated to RGB) -> one NHWC logits
        tensor a head, in the order of `heads`."""
        if x.shape[-1] == 1:  # gray -> RGB
            x = x.repeat(1, 1, 1, 3)
        encoded, features = self.transformer(x.permute(0, 3, 1, 2))
        return tuple(
            getattr(self, f"segmentation_head{s}")(
                getattr(self, f"decoder{s}")(encoded, features))
            for s in self.heads)


class VisionTransformer(_TransUnet):
    """TransUnet. Input (B, H, W, C) with C = 3 or 1 -> logits
    (B, H, W, num_classes).

    With `vis=True` the attention runs its plain version (Attention) and,
    after each forward, `attn_weights` holds the probabilities of every
    layer in order: one (B, heads, N, N) f32 tensor a layer, before dropout,
    detached, as the JAX model sows them into `intermediates`. The logits
    are those of `vis=False` up to the kernels' rounding."""

    def __init__(self, config, img_size: int = 224, num_classes: int = 2,
                 vis: bool = False, generator=None):
        super().__init__(config, img_size, num_classes, vis, generator)

    @property
    def attn_weights(self) -> list:
        return [block.attn.weights
                for block in self.transformer.encoder.layer]

    def forward(self, x):
        return super().forward(x)[0]


class VisionTransformerMultitask(_TransUnet):
    """Shared encoder, two decoders and heads (`multi_task_regTU`): input
    (B, H, W, C) -> a 2-tuple of NHWC logits. `add_log_vars` registers the
    uncertainty-weighted loss's (2,) parameter, as UNetMultitask's does."""

    heads = ("1", "2")
    add_log_vars = UNetMultitask.add_log_vars

    def __init__(self, config, img_size: int = 224, num_classes: int = 2,
                 generator=None):
        super().__init__(config, img_size, num_classes, generator=generator)


class VisionTransformerMultitaskEM(_TransUnet):
    """Shared encoder, six decoders and heads (`multitask_em`): a 6-tuple
    of NHWC logits."""

    heads = tuple(str(i) for i in range(1, 7))

    def __init__(self, config, img_size: int = 224, num_classes: int = 2,
                 generator=None):
        super().__init__(config, img_size, num_classes, generator=generator)


def reset_parameters(model: nn.Module, generator=None) -> None:
    """The reference's initialisation, drawn from `generator`: torch's
    defaults for convs and linear layers (kaiming-uniform weights, biases
    U(+-1/sqrt(fan_in))), then xavier-uniform MLP weights with N(0, 1e-6)
    biases; norms at weight 1 and bias 0, BN running mean 0 and var 1.
    Position embeddings stay 0."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                     generator=generator)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
    for m in model.modules():
        if isinstance(m, Mlp):
            for fc in (m.fc1, m.fc2):
                nn.init.xavier_uniform_(fc.weight, generator=generator)
                nn.init.normal_(fc.bias, std=1e-6, generator=generator)


# the model type -> the model class, as the JAX package's build_transunet
# maps them
MODEL_CLASSES = {
    "TransUnet": VisionTransformer,
    "regression_t": VisionTransformer,
    "multi_task_regTU": VisionTransformerMultitask,
    "multitask_em": VisionTransformerMultitaskEM,
}


def build_transunet(model_type: str, img_size: int, num_classes: int,
                    generator=None, **tpu_options):
    """R50-ViT-B_16 with n_skip 3 and grid img_size/16 for any key of
    MODEL_CLASSES, as the JAX package's build_transunet builds it by
    default. `fold` is accepted for config compatibility and ignored with a
    warning."""
    ignore_tpu_options(tpu_options)
    if model_type not in MODEL_CLASSES:
        raise ValueError(f"Unknown TransUnet model_type {model_type!r}")
    config = copy.deepcopy(CONFIGS["R50-ViT-B_16"])
    config.n_classes = num_classes
    config.n_skip = 3
    config.patches.grid = (img_size // 16, img_size // 16)
    return MODEL_CLASSES[model_type](config, img_size, num_classes,
                                     generator=generator)
