"""Conditional-DETR transformer, batch-first (B, N, C) (counterpart of
unet_torch_tpu/models/cltr/transformer.py).

Six encoder and six decoder layers; the decoder keeps content and positional
projections apart, concatenates sine-embedded reference points per head (the
cross-attention runs at d_model * 2 against values at d_model), modulates
them through a query_scale MLP and returns the stacked decoder states with
the reference points.

Every attention goes through the attention kernels (kernels/attention.py) as
(B, heads, N, d): in eval mode `fused_attention`; in train mode with dropout
the `FlashAttention` Function with the key-padding bias and the rate
together, for all three kinds of attention. (The JAX package sends only the
unmasked decoder self-attention through its dropout kernel and the two
masked ones through an einsum with a hardware-RNG mask, a workaround of its
chip that is not carried over.) The decoder self-attention's mask is then
JAX's counter hash bit for bit; each attention draws its 32-bit seed from
the generator bound with `set_attention_seed_generator`, a host generator,
so that drawing reads nothing from the device.

Under tensor parallelism (parallel/tensor.py::shard_model_tp, the JAX
package's roles): the encoder's stacked q, k, v projections and every
`linear1` hold a rank's share of the output features, every `out_proj` and
`linear2` its share of the input features; the decoder's content and
positional projections stay whole, and its attentions take the rank's
heads of them. Each rank's attention runs on its nhead / model heads with
the mask of their place in the whole batch.

On a spatial mesh (the "spatial" role, parallel/spatial.py) a rank's tokens
are its strip of the image's rows. The encoder's self-attention keeps the
strip's queries and gathers the keys and values of every strip
(core/dist.py::all_gather_dim), its mask's query rows from the strip's
first token; its token-wise layers are local. After the encoder the memory,
its positions and the key-padding mask are gathered once, and the decoder
runs on every strip's rank, replicated (its dropouts and attention masks
are the whole batch's rows, alike on every strip). Every rank then
differentiates its own copy of the one loss: the gather's backward sums the
ranks' gradients of a strip, M times that loss's, and
DistributedDataParallel's mean over the world group divides the M back out
(train/cltr_steps.py).

Parameters are f32 and every layer computes in its input's dtype, except the
reference-point head, which stays f32. Modules carry the reference's
state_dict names (`encoder.layers.N.self_attn.in_proj_weight`,
`decoder.layers.N.sa_qcontent_proj`, `decoder.ref_point_head.layers.N`, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from unet_torch_tpu_torch.kernels.attention import (
    FlashAttention,
    fused_attention,
    padding_bias,
)
from unet_torch_tpu_torch.models.cltr.position_encoding import (
    gen_sineembed_for_position,
)
from unet_torch_tpu_torch.core.dist import all_gather_dim, copy_to_group
from unet_torch_tpu_torch.models.transunet.vit import LayerNorm, Linear
from unet_torch_tpu_torch.nn.dropout import Dropout, MeshBound


class MLP(nn.Module):
    """ReLU MLP; `last_zero_init` zeroes the last layer's weight."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, last_zero_init: bool = False):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))
        self.last_zero_init = last_zero_init

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


def raw_attention(q, k, v, num_heads, key_padding_mask=None,
                  dropout_rate=0.0, seed=None, offsets=None):
    """Pre-projected multi-head attention: q, k (B, Nq/Nk, E), v (B, Nk, V),
    scale 1/sqrt(E/heads) -> (B, Nq, V).

    `seed` None or rate 0 is `fused_attention` (the eval kernel, or under
    autograd the train kernels at rate 0); otherwise the train kernels drop
    probabilities at `dropout_rate` with the counter-hash mask of `seed`,
    placed in the whole batch by `offsets` (kernels/attention.py)."""
    b, nq, e = q.shape
    nk, vd = k.shape[1], v.shape[-1]
    hd, vhd = e // num_heads, vd // num_heads
    qh = q.view(b, nq, num_heads, hd).transpose(1, 2).contiguous()
    kh = k.view(b, nk, num_heads, hd).transpose(1, 2).contiguous()
    vh = v.view(b, nk, num_heads, vhd).transpose(1, 2).contiguous()
    scale = hd ** -0.5
    if seed is None or dropout_rate == 0.0:
        out = fused_attention(qh, kh, vh, scale=scale,
                              key_padding_mask=key_padding_mask)
    else:
        bias = (None if key_padding_mask is None
                else padding_bias(key_padding_mask))
        out = FlashAttention.apply(qh, kh, vh, bias, seed,
                                   float(dropout_rate), scale, offsets)
    return out.transpose(1, 2).reshape(b, nq, vd)


def _heads(x, num_heads: int, mesh):
    """The rank's num_heads / model heads of a (B, N, width) tensor whose
    width is num_heads blocks, entered into the tensor-parallel group."""
    b, n, width = x.shape
    x = copy_to_group(x, mesh.model_group)
    per = width // num_heads
    h = num_heads // mesh.model
    return x.reshape(b, n, num_heads, per)[:, :, mesh.m * h:(mesh.m + 1) * h] \
        .reshape(b, n, h * per)


def gather_mask(mask, group):
    """A (B, N_strip) bool key-padding mask of every strip, (B, N), or
    None without one."""
    if mask is None or group is None:
        return mask
    with torch.no_grad():
        return all_gather_dim(mask.float(), group, 1) > 0.5


class RawAttention(MeshBound, nn.Module):
    """Attention over projected q, k, v; only the out projection is
    learned (the reference's vendored MultiheadAttention). With a mesh of
    model > 1 under the tensor role, q, k and v are whole and each rank
    keeps its heads of them (`projected_heads` False: FullAttention's own
    projections give only the rank's). Under the spatial role an attention
    whose queries are the image's tokens (`strip_queries`) gathers k and v
    of every strip; the key-padding mask comes whole."""

    projected_heads = False
    strip_queries = False

    def __init__(self, num_heads: int, vdim: int, dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.rate = dropout_rate
        self.out_proj = Linear(vdim, vdim)
        self.seed_generator: torch.Generator | None = None

    def _seed(self):
        if not (self.training and self.rate and torch.is_grad_enabled()):
            return None
        gen = self.seed_generator
        if gen is None:
            raise RuntimeError("train-mode attention dropout needs a seed "
                               "generator: call set_attention_seed_generator")
        return int(torch.randint(0, 2 ** 32, (), generator=gen,
                                 device=gen.device))

    def forward(self, q, k, v, key_padding_mask=None):
        mesh, heads, offsets = self.mesh, self.num_heads, None
        if mesh is not None and mesh.role == "spatial":
            q_off, group = 0, self.strip_group
            if self.strip_queries and group is not None:
                q_off = mesh.m * q.shape[1]
                k, v = all_gather_dim(torch.stack([k, v]), group, 2)
            offsets = (mesh.d * q.shape[0], 0, heads, q_off)
        elif mesh is not None:
            heads //= mesh.model
            if mesh.model > 1 and not self.projected_heads:
                q, k, v = (_heads(t, self.num_heads, mesh) for t in (q, k, v))
            offsets = (mesh.d * q.shape[0], mesh.m * heads, self.num_heads)
        out = raw_attention(q, k, v, heads, key_padding_mask,
                            dropout_rate=self.rate, seed=self._seed(),
                            offsets=offsets)
        return self.out_proj(out)


class FullAttention(RawAttention):
    """torch's nn.MultiheadAttention: stacked q, k, v projections
    (`in_proj_weight`, `in_proj_bias`), then RawAttention. Under tensor
    parallelism each third of the stack holds the rank's heads. It is the
    encoder's self-attention: its queries are the image's tokens."""

    projected_heads = True
    strip_queries = True

    def __init__(self, embed_dim: int, num_heads: int,
                 dropout_rate: float = 0.0):
        super().__init__(num_heads, embed_dim, dropout_rate)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))

    def forward(self, q, k, v, key_padding_mask=None):
        if self.mesh is not None and self.mesh.role == "tensor":
            q, k, v = (copy_to_group(t, self.mesh.model_group)
                       for t in (q, k, v))
        w = self.in_proj_weight.to(q.dtype).chunk(3)
        bias = self.in_proj_bias.to(q.dtype).chunk(3)
        q, k, v = (F.linear(x, wi, bi) for x, wi, bi in zip((q, k, v), w,
                                                            bias))
        return super().forward(q, k, v, key_padding_mask)


def set_attention_seed_generator(module: nn.Module,
                                 generator: torch.Generator | None) -> None:
    """Bind `generator` to every attention of `module`. A host generator
    keeps the draw off the device."""
    for m in module.modules():
        if isinstance(m, RawAttention):
            m.seed_generator = generator


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.self_attn = FullAttention(d_model, nhead, dropout_rate)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout_rate)

    def forward(self, src, pos, key_padding_mask=None):
        q = k = src + pos
        src2 = self.self_attn(q, k, src, key_padding_mask)
        src = self.norm1(src + self.dropout(src2, spatial_dim=1))
        src2 = self.linear2(self.dropout(F.relu(self.linear1(src)),
                                         model_dim=-1, spatial_dim=1))
        return self.norm2(src + self.dropout(src2, spatial_dim=1))


class TransformerDecoderLayer(nn.Module):
    """Separate content and positional projections; the cross-attention runs
    at d_model * 2 through a per-head concat of the content half and the
    sine-position half. Only the first layer keeps `ca_qpos_proj`."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout_rate: float = 0.1, has_ca_qpos_proj: bool = True):
        super().__init__()
        self.nhead = nhead
        for name in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj",
                     "sa_kpos_proj", "sa_v_proj", "ca_qcontent_proj",
                     "ca_kcontent_proj", "ca_kpos_proj", "ca_v_proj",
                     "ca_qpos_sine_proj"):
            setattr(self, name, Linear(d_model, d_model))
        self.ca_qpos_proj = (Linear(d_model, d_model) if has_ca_qpos_proj
                             else None)
        self.self_attn = RawAttention(nhead, d_model, dropout_rate)
        self.cross_attn = RawAttention(nhead, d_model, dropout_rate)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout_rate)

    def forward(self, tgt, memory, pos, query_pos, query_sine_embed,
                is_first: bool, key_padding_mask=None):
        q = self.sa_qcontent_proj(tgt) + self.sa_qpos_proj(query_pos)
        k = self.sa_kcontent_proj(tgt) + self.sa_kpos_proj(query_pos)
        tgt2 = self.self_attn(q, k, self.sa_v_proj(tgt))
        # the queries are replicated over a spatial mesh's strips
        tgt = self.norm1(tgt + self.dropout(tgt2, spatial_dim=None))

        q = self.ca_qcontent_proj(tgt)
        k = self.ca_kcontent_proj(memory)
        v = self.ca_v_proj(memory)
        k_pos = self.ca_kpos_proj(pos)
        if is_first and self.ca_qpos_proj is not None:
            q = q + self.ca_qpos_proj(query_pos)
            k = k + k_pos
        b, nq, d = q.shape
        hw = k.shape[1]
        hd = d // self.nhead
        qse = self.ca_qpos_sine_proj(query_sine_embed)
        q = torch.cat([q.view(b, nq, self.nhead, hd),
                       qse.view(b, nq, self.nhead, hd)],
                      dim=3).view(b, nq, d * 2)
        k = torch.cat([k.view(b, hw, self.nhead, hd),
                       k_pos.view(b, hw, self.nhead, hd)],
                      dim=3).view(b, hw, d * 2)
        tgt2 = self.cross_attn(q, k, v, key_padding_mask)
        tgt = self.norm2(tgt + self.dropout(tgt2, spatial_dim=None))

        tgt2 = self.linear2(self.dropout(F.relu(self.linear1(tgt)),
                                         model_dim=-1, spatial_dim=None))
        return self.norm3(tgt + self.dropout(tgt2, spatial_dim=None))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model, nhead, num_layers, dim_feedforward,
                 dropout_rate):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                    dropout_rate)
            for _ in range(num_layers))

    def forward(self, src, pos, key_padding_mask=None):
        for layer in self.layers:
            src = layer(src, pos, key_padding_mask)
        return src


class TransformerDecoder(nn.Module):
    def __init__(self, d_model, nhead, num_layers, dim_feedforward,
                 dropout_rate):
        super().__init__()
        self.d_model = d_model
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, nhead, dim_feedforward,
                                    dropout_rate, has_ca_qpos_proj=(i == 0))
            for i in range(num_layers))
        self.norm = LayerNorm(d_model, eps=1e-5)
        self.query_scale = MLP(d_model, d_model, d_model, 2)
        self.ref_point_head = MLP(d_model, d_model, 2, 2)

    def forward(self, memory, pos, query_pos, key_padding_mask=None):
        # the reference-point head stays f32: its sigmoid places the points
        reference_points = torch.sigmoid(
            self.ref_point_head(query_pos.float()))  # (B, Q, 2)
        sine = gen_sineembed_for_position(reference_points,
                                          self.d_model).to(query_pos.dtype)
        output = torch.zeros_like(query_pos)
        intermediate = []
        for i, layer in enumerate(self.layers):
            query_sine_embed = sine if i == 0 else sine * self.query_scale(
                output)
            output = layer(output, memory, pos, query_pos, query_sine_embed,
                           is_first=(i == 0),
                           key_padding_mask=key_padding_mask)
            intermediate.append(self.norm(output))
        return torch.stack(intermediate), reference_points


class Transformer(MeshBound, nn.Module):
    """src (B, H, W, C), mask (B, H, W) bool or None, query_embed (Q, C),
    pos_embed (B, H, W, C) -> (hs (L, B, Q, C), reference_points (B, Q, 2)
    f32), and with `return_memory` the encoder memory (B, H, W, C)."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout_rate: float = 0.1,
                 return_memory: bool = False, generator=None):
        super().__init__()
        self.return_memory = return_memory
        self.encoder = TransformerEncoder(d_model, nhead, num_encoder_layers,
                                          dim_feedforward, dropout_rate)
        self.decoder = TransformerDecoder(d_model, nhead, num_decoder_layers,
                                          dim_feedforward, dropout_rate)
        reset_parameters(self, generator)

    def forward(self, src, mask, query_embed, pos_embed):
        b, h, w, c = src.shape
        dtype = src.dtype
        src = src.reshape(b, h * w, c)
        pos = pos_embed.reshape(b, h * w, -1).to(dtype)
        mask_flat = None if mask is None else mask.reshape(b, h * w)
        # a strip's keys are every strip's: so is their padding mask
        group = self.strip_group
        mask_flat = gather_mask(mask_flat, group)
        query_pos = query_embed[None].expand(b, -1, -1).to(dtype)
        memory = self.encoder(src, pos, mask_flat)
        if group is not None:
            memory = all_gather_dim(memory, group, 1)
            pos = all_gather_dim(pos, group, 1)
        hs, reference_points = self.decoder(memory, pos, query_pos,
                                            mask_flat)
        if self.return_memory:
            return hs, reference_points, memory.reshape(b, -1, w, c)
        return hs, reference_points


def reset_parameters(module: nn.Module, generator=None) -> None:
    """The JAX package's initialisation, drawn from `generator`:
    xavier-uniform weights and zero biases for every projection, an MLP's
    last weight zero under `last_zero_init`, norms at 1 and 0."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, FullAttention):
            for w in m.in_proj_weight.data.chunk(3):
                nn.init.xavier_uniform_(w, generator=generator)
            nn.init.zeros_(m.in_proj_bias)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
    for m in module.modules():
        if isinstance(m, MLP) and m.last_zero_init:
            nn.init.zeros_(m.layers[-1].weight)
