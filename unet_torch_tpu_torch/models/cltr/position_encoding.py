"""Positional encodings of the CLTR transformer (counterpart of
unet_torch_tpu/models/cltr/position_encoding.py): NHWC maps, batch-first
tokens, f32.

On a strip of a spatial mesh (`group`, the strips' ranks in order) the
sine embedding counts a column's unmasked rows from the image's top: the
strip's own cumulative count plus the strips' above it
(core/dist.py::exclusive_prefix_sum), normalised by the whole column's
count; the learned one reads its rows by their global index.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from unet_torch_tpu_torch.core.dist import all_reduce_sum, exclusive_prefix_sum
from unet_torch_tpu_torch.nn.dropout import MeshBound


def _interleave_sin_cos(x):
    """(..., F) -> (..., F): sin of the even columns and cos of the odd
    ones, interleaved."""
    return torch.stack([torch.sin(x[..., 0::2]), torch.cos(x[..., 1::2])],
                       dim=-1).flatten(-2)


def sine_position_embedding(mask, num_pos_feats=128, temperature=10000,
                            normalize=True, scale=2 * math.pi, group=None):
    """mask: (B, H, W) bool, True on padded pixels -> (B, H, W, 2*feats);
    with `group`, mask is a strip of the image (module docstring)."""
    not_mask = (~mask).to(torch.float32)
    y_embed = torch.cumsum(not_mask, dim=1)
    total = y_embed[:, -1:, :]
    if group is not None:
        column = not_mask.sum(dim=1, keepdim=True)
        y_embed = y_embed + exclusive_prefix_sum(column, group)
        total = all_reduce_sum(column, group)
    x_embed = torch.cumsum(not_mask, dim=2)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (total + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=3)


class PositionEmbeddingLearned(MeshBound, nn.Module):
    """Learned 50x50 row and column embeddings, U(0, 1) at the start."""

    def __init__(self, num_pos_feats: int = 256, generator=None):
        super().__init__()
        self.row_embed = nn.Embedding(50, num_pos_feats)
        self.col_embed = nn.Embedding(50, num_pos_feats)
        for emb in (self.row_embed, self.col_embed):
            nn.init.uniform_(emb.weight, generator=generator)

    def forward(self, x):
        b, h, w, _ = x.shape
        first = 0 if self.strip_group is None else self.mesh.m * h
        row = self.row_embed.weight[first:first + h]
        col = self.col_embed.weight[:w]
        feats = row.shape[-1]
        pos = torch.cat([col[None, :, :].expand(h, w, feats),
                         row[:, None, :].expand(h, w, feats)], dim=-1)
        return pos[None].expand(b, h, w, 2 * feats)


def gen_sineembed_for_position(pos_tensor, d_model: int = 256):
    """(B, Q, 2) normalised xy -> (B, Q, d_model) sine embedding."""
    half = d_model // 2
    dim_t = torch.arange(half, dtype=torch.float32, device=pos_tensor.device)
    dim_t = 10000 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / half)
    x_embed = pos_tensor[:, :, 0] * (2 * math.pi)
    y_embed = pos_tensor[:, :, 1] * (2 * math.pi)
    pos_x = _interleave_sin_cos(x_embed[:, :, None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[:, :, None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=2)
