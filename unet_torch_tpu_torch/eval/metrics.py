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
    """Class map from (..., C) logits, returned as uint8: the JAX package's
    rule. Up to 8 classes, plane compares: class k replaces the best so far
    where its logit is strictly greater, so the first maximum wins, a NaN
    at class 0 keeps class 0 and a NaN past it is passed over. Past 8
    classes, torch.argmax, as jnp.argmax there (a NaN is the maximum).

    Same result as the reference's softmax->argmax chain on finite logits,
    since softmax is monotone."""
    c = logits.shape[-1]
    if c > 256:
        raise ValueError(f"{c} classes do not fit uint8")
    if c > 8:
        return torch.argmax(logits, dim=-1).to(torch.uint8)
    # the plane compares in one argmax: a NaN never wins (-inf, and a
    # -inf at class 0 wins ties by coming first), then class 0 where its
    # own logit is NaN
    idx = torch.argmax(torch.where(logits.isnan(), -torch.inf, logits),
                       dim=-1)
    return torch.where(logits[..., 0].isnan(), 0, idx).to(torch.uint8)


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
