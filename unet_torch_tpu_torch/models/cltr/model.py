"""ConditionalDETR point-detection model (CLTR) (counterpart of
unet_torch_tpu/models/cltr/model.py).

ResNet-50 with frozen BN -> 1x1 input_proj -> conditional-DETR transformer
-> per-query class logits and channel_point regression on inverse-sigmoid
reference-point offsets; 2000 queries; auxiliary outputs per decoder layer.
Images are NHWC and are cast to the model's compute `dtype`; parameters stay
f32. Logits and points leave in f32: the criterion stays in full precision.

On a spatial mesh (parallel/spatial.py) a rank's images are its strips of
the rows: the backbone, the padding mask (by the global nearest index), the
position embeddings and the encoder run on the strip, the decoder on the
gathered memory, replicated on every strip's rank (transformer.py), so the
outputs are the whole images' on every rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from unet_torch_tpu_torch.core.precision import resolve_precision
from unet_torch_tpu_torch.models.cltr.backbone import ResNet50
from unet_torch_tpu_torch.models.cltr.position_encoding import (
    PositionEmbeddingLearned,
    sine_position_embedding,
)
from unet_torch_tpu_torch.models.cltr.transformer import (
    MLP,
    Transformer,
    reset_parameters,
)
from unet_torch_tpu_torch.models.transunet.vit import Linear
from unet_torch_tpu_torch.nn.dropout import MeshBound


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def nearest_index(n_in: int, n_out: int, device=None):
    """The source index of each of `n_out` outputs of a nearest resize from
    `n_in`: floor((i + 0.5) * n_in / n_out) in f32, as jax.image.resize's
    "nearest" picks it. The ratio is formed first, as n_in * (1 / n_out),
    which is how XLA evaluates it: only then do outputs that fall exactly
    between two source pixels pick the same one."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    ratio = torch.tensor(float(n_in)) * (1.0 / torch.tensor(float(n_out)))
    return ((i + 0.5) * ratio.item()).floor().long().clamp(max=n_in - 1)


def feature_mask(mask, b: int, fh: int, fw: int, device, m: int = 0,
                 strips: int = 1):
    """The (B, H, W) padding mask nearest-resized to the feature map, or all
    False without one. With `strips`, mask and map are strip m of equal
    strips of the image and of the map: the map's rows take the image rows
    of their global nearest index, which lie in the strip."""
    if mask is None:
        return torch.zeros((b, fh, fw), dtype=torch.bool, device=device)
    h = mask.shape[1]
    rows = nearest_index(h * strips, fh * strips, device)[
        m * fh:(m + 1) * fh] - m * h
    if strips > 1 and not (0 <= int(rows.min()) and int(rows.max()) < h):
        raise ValueError(f"feature rows of strip {m} read image rows outside "
                         "it: the strips' heights are not the map's times "
                         "the backbone's stride")
    cols = nearest_index(mask.shape[2], fw, device)
    return mask[:, rows][:, :, cols]


class InputProj(nn.Conv2d):
    """1x1 conv on an NHWC map: a Linear over the channels with the conv's
    (out, in, 1, 1) weight."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype).flatten(1),
                        self.bias.to(x.dtype))


class ConditionalDETR(MeshBound, nn.Module):
    def __init__(self, num_classes: int = 2, num_queries: int = 2000,
                 channel_point: int = 3, hidden_dim: int = 256,
                 nheads: int = 8, enc_layers: int = 6, dec_layers: int = 6,
                 dim_feedforward: int = 2048, dropout_rate: float = 0.1,
                 aux_loss: bool = True, position_embedding: str = "sine",
                 dtype: torch.dtype = torch.float32,
                 backbone_layers=(3, 4, 6, 3), generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.channel_point = channel_point
        self.hidden_dim = hidden_dim
        self.dec_layers = dec_layers
        self.aux_loss = aux_loss
        self.dtype = dtype
        self.backbone = ResNet50(tuple(backbone_layers), generator=generator)
        self.pos_embed = None
        if position_embedding != "sine":
            self.pos_embed = PositionEmbeddingLearned(hidden_dim // 2,
                                                      generator=generator)
        self.input_proj = InputProj(2048, hidden_dim, 1)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.transformer = Transformer(
            hidden_dim, nheads, enc_layers, dec_layers, dim_feedforward,
            dropout_rate, generator=generator)
        self.class_embed = Linear(hidden_dim, num_classes)
        self.point_embed = MLP(hidden_dim, hidden_dim, channel_point, 3,
                               last_zero_init=True)

        nn.init.xavier_uniform_(self.input_proj.weight, generator=generator)
        nn.init.zeros_(self.input_proj.bias)
        nn.init.normal_(self.query_embed.weight, generator=generator)
        reset_parameters(self.class_embed, generator)
        reset_parameters(self.point_embed, generator)
        # the focal loss's prior: every query starts at p = 0.01
        prior_prob = 0.01
        nn.init.constant_(self.class_embed.bias,
                          -math.log((1 - prior_prob) / prior_prob))

    def forward(self, images, mask=None):
        """images (B, H, W, 3); mask (B, H, W) bool, True on padding ->
        {'pred_logits' (B, Q, num_classes), 'pred_points' (B, Q,
        channel_point), 'aux_outputs': [...]}, f32."""
        feat = self.backbone(images.to(self.dtype))
        b, fh, fw, _ = feat.shape
        group = self.strip_group
        strip = (0, 1) if group is None else (self.mesh.m, self.mesh.model)
        fmask = feature_mask(mask, b, fh, fw, feat.device, *strip)
        if self.pos_embed is None:
            pos = sine_position_embedding(fmask, self.hidden_dim // 2,
                                          group=group)
        else:
            pos = self.pos_embed(feat)
        hs, reference = self.transformer(self.input_proj(feat), fmask,
                                         self.query_embed.weight, pos)
        ref_before_sigmoid = inverse_sigmoid(reference)  # (B, Q, 2)
        offsets = F.pad(ref_before_sigmoid, (0, self.channel_point - 2))
        coords = torch.sigmoid(self.point_embed(hs).float() + offsets)
        classes = self.class_embed(hs).float()
        out = {"pred_logits": classes[-1], "pred_points": coords[-1]}
        if self.aux_loss:
            out["aux_outputs"] = [{"pred_logits": c, "pred_points": p}
                                  for c, p in zip(classes[:-1], coords[:-1])]
        return out


def build_cltr(args: dict, generator=None):
    """(model, criterion, {'point': PostProcess()}) from the flat
    `cltr_config` keys."""
    from unet_torch_tpu_torch.models.cltr.criterion import (
        PostProcess,
        SetCriterion,
        build_weight_dict,
    )

    model = ConditionalDETR(
        num_classes=2,
        num_queries=args.get("num_queries", 2000),
        channel_point=args.get("channel_point", 3),
        hidden_dim=args.get("hidden_dim", 256),
        nheads=args.get("nheads", 8),
        enc_layers=args.get("enc_layers", 6),
        dec_layers=args.get("dec_layers", 6),
        dim_feedforward=args.get("dim_feedforward", 2048),
        dropout_rate=args.get("dropout", 0.1),
        aux_loss=args.get("aux_loss", True),
        position_embedding=args.get("position_embedding", "sine"),
        dtype=resolve_precision(str(args.get("precision", "f32")).lower()),
        backbone_layers=tuple(args.get("backbone_layers", (3, 4, 6, 3))),
        generator=generator)
    weight_dict = build_weight_dict(
        cls_loss_coef=args.get("cls_loss_coef", 2),
        point_loss_coef=args.get("point_loss_coef", 5),
        dec_layers=args.get("dec_layers", 6),
        aux_loss=args.get("aux_loss", True))
    criterion = SetCriterion(
        num_classes=2, weight_dict=weight_dict,
        focal_alpha=args.get("focal_alpha", 0.25),
        cost_class=args.get("set_cost_class", 2),
        cost_point=args.get("set_cost_point", 5))
    return model, criterion, {"point": PostProcess()}


def build_cltr_default(generator=None):
    """The default configuration's model only."""
    return build_cltr({}, generator)[0]
