"""Box utilities (counterpart of unet_torch_tpu/models/cltr/box_ops.py), kept
complete for the panoptic machinery's contract: cxcywh <-> xyxy, IoU, GIoU on
tensors; masks -> boxes on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def box_cxcywh_to_xyxy(x):
    x_c, y_c, w, h = x.unbind(-1)
    return torch.stack([x_c - 0.5 * w, y_c - 0.5 * h,
                        x_c + 0.5 * w, y_c + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(x):
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1, boxes2):
    """Pairwise IoU: (N, 4), (M, 4) -> iou (N, M), union (N, M)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / union, union


def generalized_box_iou(boxes1, boxes2):
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.maximum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) binary masks -> (N, 4) xyxy boxes, on the host."""
    if masks.size == 0:
        return np.zeros((0, 4))
    boxes = np.zeros((masks.shape[0], 4))
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(xs):
            boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return boxes
