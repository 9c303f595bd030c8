"""The main path's losses (counterpart of unet_torch_tpu/losses/functional.py).

`pred` is NHWC logits (B, H, W, C), as in the JAX package; `target` is
(B, H, W) class indices (any numeric dtype). Everything is computed in f32,
whatever the logits' dtype, and returns a 0-d f32 tensor.

The JAX package's `*_planes_folded` family evaluates the same values on
W-folded class planes for the TPU's fused head and is not carried over;
`dice_bce_mc_loss` is also computed there on per-class planes for C <= 8
(`_dice_bce_mc_planes`), which is the same value summed in another order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits, labels, num_classes: int):
    """torch CrossEntropyLoss (mean) on NHWC logits. The binary case is
    computed on the logit margin t = z1 - z0 as softplus(t) - y t, as the
    JAX package computes it (the same value)."""
    logits = logits.float()
    if num_classes == 2 and logits.shape[-1] == 2:
        t = logits[..., 1] - logits[..., 0]
        y = (labels > 0).float()
        return torch.mean(F.softplus(t) - y * t)
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).float()
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def multiclass_dice_loss(pred, target, num_classes: int, weights=None,
                         softmax: bool = False):
    """DiceLoss: one-hot target, per-class soft dice with squared
    denominators, smooth 1e-5, mean over classes (or weighted sum / C)."""
    pred = pred.float()
    if softmax:
        pred = torch.softmax(pred, dim=-1)
    onehot = F.one_hot(target.long(), num_classes).float()
    smooth = 1e-5
    intersect = torch.sum(pred * onehot, dim=(0, 1, 2))
    z = torch.sum(pred * pred, dim=(0, 1, 2))
    y = torch.sum(onehot * onehot, dim=(0, 1, 2))
    dice = 1.0 - (2.0 * intersect + smooth) / (z + y + smooth)
    if weights is None:
        return torch.mean(dice)
    w = torch.as_tensor(weights, dtype=torch.float32, device=pred.device)
    return torch.sum(dice * w) / num_classes


def _squeeze_last(pred):
    if pred.dim() == 4 and pred.shape[-1] == 1:
        return pred[..., 0]
    return pred


def binary_dice_loss(pred, target, smooth: float = 1.0):
    """BinaryDiceLoss: sigmoid, per-sample flattened dice with smooth 1, mean
    over the batch."""
    p = torch.sigmoid(_squeeze_last(pred).float())
    t = target.float()
    p = p.reshape(p.shape[0], -1)
    t = t.reshape(t.shape[0], -1)
    num = 2.0 * torch.sum(p * t, dim=1) + smooth
    den = torch.sum(p.abs() + t.abs(), dim=1) + smooth
    return torch.mean(1.0 - num / den)


def dice_bce_mc_loss(pred, target, num_classes: int, bce_weight: float = 0.5):
    """dice_bce_mc, the flagship: bce_weight * CE + (1 - bce_weight) *
    DiceLoss(softmax)."""
    ce = softmax_cross_entropy(pred, target, num_classes)
    dice = multiclass_dice_loss(pred, target, num_classes, softmax=True)
    return bce_weight * ce + (1.0 - bce_weight) * dice


def dice_score(pred, target, num_classes: int | None = None):
    """Dice coefficient (higher is better): the `dice_score(_mc)` metric."""
    if num_classes and num_classes > 1:
        return 1.0 - multiclass_dice_loss(pred, target, num_classes,
                                          softmax=True)
    return 1.0 - binary_dice_loss(pred, target)
