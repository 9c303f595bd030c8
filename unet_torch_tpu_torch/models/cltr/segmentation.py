"""DETR's panoptic segmentation machinery (counterpart of
unet_torch_tpu/models/cltr/segmentation.py), off the CLTR main path: the
reference ships these and never builds them (`masks: false`). DETRsegm puts
per-query masks on the conditional-DETR stack; the two postprocessors turn
outputs into COCO-style results on the host. NHWC tensors at the public
functions; no hand-written kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unet_torch_tpu_torch.models.cltr.backbone import ResNet50
from unet_torch_tpu_torch.models.cltr.criterion import to_numpy
from unet_torch_tpu_torch.models.cltr.model import (
    InputProj,
    feature_mask,
    inverse_sigmoid,
    nearest_index,
)
from unet_torch_tpu_torch.models.cltr.position_encoding import (
    sine_position_embedding,
)
from unet_torch_tpu_torch.models.cltr.transformer import (
    MLP,
    Transformer,
    reset_parameters,
)
from unet_torch_tpu_torch.nn.dropout import Dropout


class MHAttentionMap(nn.Module):
    """Per-head softmax attention of each query over the feature map, no
    value product: q (B, Q, D), k (B, H, W, D) -> (B, Q, heads, H, W)."""

    def __init__(self, query_dim: int, hidden_dim: int, num_heads: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.q_linear = nn.Linear(query_dim, hidden_dim)
        self.k_linear = nn.Linear(query_dim, hidden_dim)
        self.dropout = Dropout(dropout_rate)

    def forward(self, q, k, mask=None):
        q = self.q_linear(q)
        k = self.k_linear(k)  # the reference's 1x1 conv on NHWC
        b, nq, _ = q.shape
        _, h, w, _ = k.shape
        ch = self.hidden_dim // self.num_heads
        qh = q.view(b, nq, self.num_heads, ch)
        kh = k.view(b, h, w, self.num_heads, ch)
        weights = torch.einsum("bqnc,bhwnc->bqnhw", qh * float(ch) ** -0.5,
                               kh)
        if mask is not None:
            weights = weights.masked_fill(mask[:, None, None, :, :],
                                          float("-inf"))
        weights = torch.softmax(weights.flatten(3), dim=-1).view(
            weights.shape)
        return self.dropout(weights)


def _group_norm(channels: int) -> nn.GroupNorm:
    # 8 groups at the reference's widths; gcd keeps tiny widths valid
    return nn.GroupNorm(math.gcd(8, channels), channels, eps=1e-5)


def _nearest_to(x, hw):
    """NCHW nearest resize, the source pixels as jax.image.resize picks
    them."""
    rows = nearest_index(x.shape[2], hw[0], x.device)
    cols = nearest_index(x.shape[3], hw[1], x.device)
    return x[:, :, rows][:, :, :, cols]


class MaskHeadSmallConv(nn.Module):
    """FPN-style mask head: a conv / GroupNorm / ReLU ladder with nearest
    upsampling and 1x1 adapters on the three FPN skips, one output channel.
    x (BQ, H, W, dim); fpns: three NHWC maps at 2x, 4x, 8x the resolution,
    already expanded to BQ."""

    def __init__(self, dim: int, fpn_dims, context_dim: int):
        super().__init__()
        d = context_dim
        inter = [d // 2, d // 4, d // 8, d // 16]
        widths = [dim, dim, inter[0], inter[1], inter[2], inter[3]]
        for i in range(5):
            setattr(self, f"lay{i + 1}", nn.Conv2d(widths[i], widths[i + 1],
                                                   3, padding=1))
            setattr(self, f"gn{i + 1}", _group_norm(widths[i + 1]))
        for i, fpn_dim in enumerate(fpn_dims):
            setattr(self, f"adapter{i + 1}", nn.Conv2d(fpn_dim, inter[i], 1))
        self.out_lay = nn.Conv2d(inter[3], 1, 3, padding=1)

    def forward(self, x, fpns):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.gn1(self.lay1(x)))
        x = F.relu(self.gn2(self.lay2(x)))
        for i, fpn in enumerate(fpns):
            adapter = getattr(self, f"adapter{i + 1}")(fpn.permute(0, 3, 1, 2))
            x = adapter + _nearest_to(x, adapter.shape[2:])
            x = F.relu(getattr(self, f"gn{i + 3}")(
                getattr(self, f"lay{i + 3}")(x)))
        return self.out_lay(x).permute(0, 2, 3, 1)


class DETRsegm(nn.Module):
    """Conditional-DETR detector with the panoptic mask head: returns
    {'pred_logits', 'pred_points', 'pred_masks' (B, Q, H/8, W/8)}, f32."""

    def __init__(self, num_classes: int = 2, num_queries: int = 100,
                 channel_point: int = 3, hidden_dim: int = 256,
                 nheads: int = 8, enc_layers: int = 6, dec_layers: int = 6,
                 dim_feedforward: int = 2048, dropout_rate: float = 0.1,
                 backbone_layers=(3, 4, 6, 3), generator=None):
        super().__init__()
        self.num_queries = num_queries
        self.hidden_dim = hidden_dim
        self.nheads = nheads
        self.channel_point = channel_point
        self.backbone = ResNet50(tuple(backbone_layers), return_interm=True,
                                 generator=generator)
        self.input_proj = InputProj(2048, hidden_dim, 1)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.transformer = Transformer(
            hidden_dim, nheads, enc_layers, dec_layers, dim_feedforward,
            dropout_rate, return_memory=True, generator=generator)
        self.class_embed = nn.Linear(hidden_dim, num_classes)
        self.point_embed = MLP(hidden_dim, hidden_dim, channel_point, 3,
                               last_zero_init=True)
        self.bbox_attention = MHAttentionMap(hidden_dim, hidden_dim, nheads)
        self.mask_head = MaskHeadSmallConv(hidden_dim + nheads,
                                           (1024, 512, 256), hidden_dim)
        nn.init.xavier_uniform_(self.input_proj.weight, generator=generator)
        nn.init.zeros_(self.input_proj.bias)
        nn.init.normal_(self.query_embed.weight, generator=generator)
        for part in (self.class_embed, self.point_embed,
                     self.bbox_attention):
            reset_parameters(part, generator)
        nn.init.constant_(self.class_embed.bias, -math.log((1 - 0.01) / 0.01))
        for m in self.mask_head.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_uniform_(m.weight, a=1, generator=generator)
                nn.init.zeros_(m.bias)

    def forward(self, images, mask=None):
        l1, l2, l3, l4 = self.backbone(images)
        b, fh, fw, _ = l4.shape
        fmask = feature_mask(mask, b, fh, fw, l4.device)
        pos = sine_position_embedding(fmask, self.hidden_dim // 2)
        src = self.input_proj(l4)
        hs, reference, memory = self.transformer(
            src, fmask, self.query_embed.weight, pos)
        logits = self.class_embed(hs[-1])
        offsets = F.pad(inverse_sigmoid(reference),
                        (0, self.channel_point - 2))
        points = torch.sigmoid(self.point_embed(hs[-1]) + offsets)
        bbox_mask = self.bbox_attention(hs[-1], memory, mask=fmask)
        nq = self.num_queries
        x = torch.cat([src.repeat_interleave(nq, dim=0),
                       bbox_mask.permute(0, 1, 3, 4, 2).reshape(
                           b * nq, fh, fw, self.nheads)], dim=-1)
        fpns = [f.repeat_interleave(nq, dim=0) for f in (l3, l2, l1)]
        seg = self.mask_head(x, fpns)
        return {"pred_logits": logits, "pred_points": points,
                "pred_masks": seg.view(b, nq, seg.shape[1], seg.shape[2])}


def _bilinear_resize(masks: np.ndarray, h: int, w: int) -> np.ndarray:
    """(..., H, W) -> (..., h, w), half-pixel centres without antialiasing
    (upsampling), as jax.image.resize's "bilinear"."""
    t = torch.from_numpy(np.ascontiguousarray(masks, np.float32))
    lead = t.shape[:-2]
    out = F.interpolate(t.reshape(1, -1, *t.shape[-2:]), size=(h, w),
                        mode="bilinear", align_corners=False)
    return out.reshape(*lead, h, w).numpy()


def postprocess_segm(results, outputs, orig_target_sizes, max_target_sizes,
                     threshold: float = 0.5):
    """Bilinear-resize the predicted masks to the padded size, threshold the
    sigmoid at `threshold`, crop to each image's unpadded size,
    nearest-resize to the original size; fills `results[i]["masks"]`."""
    max_h = max(int(t[0]) for t in max_target_sizes)
    max_w = max(int(t[1]) for t in max_target_sizes)
    up = _bilinear_resize(to_numpy(outputs["pred_masks"]), max_h, max_w)
    binm = 1 / (1 + np.exp(-up)) > threshold
    for i, (t, tt) in enumerate(zip(max_target_sizes, orig_target_sizes)):
        img_h, img_w = int(t[0]), int(t[1])
        cur = torch.from_numpy(binm[i][:, :img_h, :img_w].astype(np.float32))
        cur = _nearest_to(cur[None], (int(tt[0]), int(tt[1])))[0].numpy()
        results[i]["masks"] = cur.astype(np.uint8)[:, None]
    return results


def postprocess_panoptic(outputs, processed_sizes, target_sizes=None,
                         is_thing_map=None, threshold: float = 0.85):
    """Per image: keep confident non-background queries, merge their masks
    by argmax into one id map, merge stuff classes, drop segments of 4
    pixels or fewer (merging again after each drop), and emit
    {'png_string', 'segments_info'}."""
    import cv2

    if target_sizes is None:
        target_sizes = processed_sizes
    logits = to_numpy(outputs["pred_logits"])
    raw_masks = to_numpy(outputs["pred_masks"])
    if is_thing_map is None:
        is_thing_map = {i: True for i in range(logits.shape[-1])}
    preds = []
    for cur_logits, cur_masks, size, target_size in zip(
            logits, raw_masks, processed_sizes, target_sizes):
        e = np.exp(cur_logits - cur_logits.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
        scores, labels = probs.max(-1), probs.argmax(-1)
        keep = (labels != logits.shape[-1] - 1) & (scores > threshold)
        cur_scores, cur_classes = scores[keep], labels[keep]
        h, w = int(size[0]), int(size[1])
        kept = cur_masks[keep]
        if kept.size:
            kept = np.stack([cv2.resize(m, (w, h),
                                        interpolation=cv2.INTER_LINEAR)
                             for m in kept])
        else:
            kept = np.zeros((0, h, w), np.float32)

        stuff_equiv = {}
        for k, label in enumerate(cur_classes):
            if not is_thing_map.get(int(label), True):
                stuff_equiv.setdefault(int(label), []).append(k)

        def get_ids_area(masks, scores, dedup=False):
            if masks.shape[0] == 0:
                m_id = np.zeros((h, w), np.int64)
            else:
                flat = masks.reshape(masks.shape[0], -1)
                em = np.exp(flat - flat.max(0, keepdims=True))
                m_id = (em / em.sum(0, keepdims=True)).argmax(0).reshape(h, w)
            if dedup:
                for equiv in stuff_equiv.values():
                    for eq_id in equiv[1:]:
                        m_id[m_id == eq_id] = equiv[0]
            fh, fw = int(target_size[0]), int(target_size[1])
            seg_img = cv2.resize(m_id.astype(np.int32), (fw, fh),
                                 interpolation=cv2.INTER_NEAREST)
            area = [int((seg_img == i).sum()) for i in range(len(scores))]
            return area, seg_img

        area, seg_img = get_ids_area(kept, cur_scores, dedup=True)
        if len(cur_classes):
            while True:
                small = np.asarray([area[i] <= 4
                                    for i in range(len(cur_classes))], bool)
                if not small.any():
                    break
                cur_scores = cur_scores[~small]
                cur_classes = cur_classes[~small]
                kept = kept[~small]
                area, seg_img = get_ids_area(kept, cur_scores)
        else:
            cur_classes = np.ones(1, np.int64)
        segments_info = [{"id": i, "isthing": is_thing_map.get(int(c), True),
                          "category_id": int(c), "area": a}
                         for i, (a, c) in enumerate(zip(area, cur_classes))]
        # id map -> RGB png bytes (panopticapi's id2rgb)
        rgb = np.stack([seg_img % 256, (seg_img // 256) % 256,
                        (seg_img // 256 ** 2) % 256], axis=-1).astype(np.uint8)
        ok, buf = cv2.imencode(".png", rgb[:, :, ::-1])  # cv2 writes BGR
        preds.append({"png_string": buf.tobytes() if ok else b"",
                      "segments_info": segments_info})
    return preds
