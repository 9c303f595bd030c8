"""Eval-side metrics (counterpart of unet_torch_tpu/eval/metrics.py): the
class map of a logits tensor, and the host-side counting metrics of the topo
warm-up loop.

MRAccuracy (the reference's loss.py:422-440): sigmoid -> 0.5-binarise ->
connected components -> mean relative count error against the dot map's
sum. Connected-component labelling runs on the host through cv2, as in the
reference and the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def class_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Class map from (..., C) logits: argmax over the trailing class axis,
    first maximum wins (torch.argmax's documented tie rule, as in the JAX
    package's plane compares), returned as uint8.

    Same result as the reference's softmax->argmax chain, since softmax is
    monotone."""
    if logits.shape[-1] > 256:
        raise ValueError(f"{logits.shape[-1]} classes do not fit uint8")
    return torch.argmax(logits, dim=-1).to(torch.uint8)


def connected_component_count(mask: np.ndarray, connectivity: int = 8) -> int:
    """Number of foreground components (background excluded)."""
    import cv2

    n, _ = cv2.connectedComponents(mask.astype(np.uint8),
                                   connectivity=connectivity)
    return int(n - 1)


def mr_accuracy(pred_logits: np.ndarray, gt_dot: np.ndarray) -> float:
    """Mean relative count error of a batch: pred_logits (B, H, W, 1) or
    (B, H, W), gt_dot (B, H, W), numpy arrays on the host."""
    if pred_logits.ndim == 4:
        pred_logits = pred_logits[..., 0]
    prob = 1.0 / (1.0 + np.exp(-pred_logits))
    pred_bin = (prob >= 0.5).astype(np.uint8)
    bsz = gt_dot.shape[0]
    mre = 0.0
    for b in range(bsz):
        count_gt = int(np.sum(gt_dot[b]))
        count_pred = connected_component_count(pred_bin[b])
        if count_gt != 0:
            mre += abs(count_gt - count_pred) / count_gt
        elif count_pred != 0:
            mre += 1.0
    return mre / bsz
