"""The flagship loss, `dice_bce_mc`, in float32: half the mean softmax
cross-entropy, half the multiclass soft Dice loss (softmax probabilities,
one-hot target, squared denominators, smooth 1e-5, sums over the whole
batch, mean over the classes); in float64 where the logits are."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dice_bce_mc(logits, target, num_classes: int, bce_weight: float = 0.5):
    if logits.dtype != torch.float64:
        logits = logits.float()
    onehot = F.one_hot(target.long(), num_classes).to(logits.dtype)
    ce = -torch.mean(torch.sum(onehot * torch.log_softmax(logits, -1), -1))
    p = torch.softmax(logits, -1)
    inter = torch.sum(p * onehot, dim=(0, 1, 2))
    z = torch.sum(p * p, dim=(0, 1, 2))
    y = torch.sum(onehot * onehot, dim=(0, 1, 2))
    dice = torch.mean(1.0 - (2.0 * inter + 1e-5) / (z + y + 1e-5))
    return bce_weight * ce + (1.0 - bce_weight) * dice


LOSSES = {"dice_bce_mc": dice_bce_mc}
