"""CLTR SetCriterion, Hungarian matcher and PostProcess (counterpart of
unet_torch_tpu/models/cltr/criterion.py).

Targets are padded to one `max_points` per batch (`pad_targets`), so every
loss is a fixed set of tensor ops with no read back to the host. The
assignment itself comes from outside: `hungarian` (scipy, on the host) or
the auction kernel (kernels/auction.py, on the device); `losses` takes the
matched query of every target slot, (L, B, T).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from unet_torch_tpu_torch.core.dist import all_reduce_


def dice_loss(inputs, targets, num_points):
    """DETR's mask dice loss."""
    inputs = torch.sigmoid(inputs).flatten(1)
    targets = targets.flatten(1)
    numerator = 2 * (inputs * targets).sum(1)
    denominator = inputs.sum(-1) + targets.sum(-1)
    loss = 1 - (numerator + 1) / (denominator + 1)
    return loss.sum() / num_points


def sigmoid_focal_loss(inputs, targets, num_points, alpha=0.25, gamma=2.0):
    """DETR's focal loss on logits."""
    prob = torch.sigmoid(inputs)
    ce = (inputs.clamp(min=0) - inputs * targets
          + torch.log1p(torch.exp(-inputs.abs())))
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss.mean(dim=1).sum() / num_points


def pad_targets(targets: Sequence[dict], max_points: int, channel_point: int):
    """On the host: a list of {'labels', 'points_macher', 'points'} -> padded
    numpy arrays (labels (B,T), points (B,T,P), match_points (B,T,P), valid
    (B,T))."""
    bsz = len(targets)
    labels = np.zeros((bsz, max_points), np.int32)
    points = np.zeros((bsz, max_points, channel_point), np.float32)
    mpoints = np.zeros((bsz, max_points, channel_point), np.float32)
    valid = np.zeros((bsz, max_points), bool)
    for i, t in enumerate(targets):
        n = min(len(t["labels"]), max_points)
        if n == 0:
            continue
        labels[i, :n] = np.asarray(t["labels"])[:n]
        pts = np.asarray(t["points"], np.float32).reshape(len(t["labels"]), -1)
        mp = np.asarray(t["points_macher"], np.float32).reshape(
            len(t["labels"]), -1)
        points[i, :n, : min(pts.shape[1], channel_point)] = \
            pts[:n, :channel_point]
        mpoints[i, :n, : min(mp.shape[1], channel_point)] = \
            mp[:n, :channel_point]
        valid[i, :n] = True
    return labels, points, mpoints, valid


def _levels(outputs):
    """The auxiliary levels, then the final output."""
    return list(outputs.get("aux_outputs", [])) + [
        {"pred_logits": outputs["pred_logits"],
         "pred_points": outputs["pred_points"]}]


@dataclasses.dataclass
class SetCriterion:
    num_classes: int = 2
    weight_dict: Dict[str, float] = None
    focal_alpha: float = 0.25
    cost_class: float = 2.0
    cost_point: float = 5.0

    def cost_matrix(self, pred_logits, pred_points, tgt_labels, tgt_points,
                    tgt_valid):
        """(B,Q,C), (B,Q,P), (B,T), (B,T,P), (B,T) -> (B,Q,T): focal class
        cost plus L1 point cost, 1e9 at invalid target slots."""
        prob = torch.sigmoid(pred_logits)
        alpha, gamma = 0.25, 2.0
        neg = (1 - alpha) * (prob ** gamma) * (-torch.log(1 - prob + 1e-8))
        pos = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
        q = pred_logits.shape[1]
        idx = tgt_labels.long()[:, None, :].expand(-1, q, -1)
        cost_class = pos.gather(2, idx) - neg.gather(2, idx)  # (B,Q,T)
        cost_point = (pred_points[:, :, None, :]
                      - tgt_points[:, None, :, :]).abs().sum(dim=-1)
        cost = self.cost_class * cost_class + self.cost_point * cost_point
        return torch.where(tgt_valid[:, None, :], cost, 1e9)

    def all_cost_matrices(self, outputs, tgt_labels, tgt_match_points,
                          tgt_valid):
        """Auxiliary and final levels -> (L, B, Q, T); level L-1 is the
        final output."""
        return torch.stack([
            self.cost_matrix(lv["pred_logits"], lv["pred_points"],
                             tgt_labels, tgt_match_points, tgt_valid)
            for lv in _levels(outputs)])

    @staticmethod
    def hungarian(cost_lbqt: np.ndarray, n_targets: np.ndarray) -> np.ndarray:
        """scipy's assignment per (level, image) on the host: match_src
        (L, B, T), the query of each valid target (0 for padded slots)."""
        from scipy.optimize import linear_sum_assignment

        L, B, Q, T = cost_lbqt.shape
        match_src = np.zeros((L, B, T), np.int32)
        for l in range(L):
            for b in range(B):
                n = int(n_targets[b])
                if n == 0:
                    continue
                rows, cols = linear_sum_assignment(cost_lbqt[l, b, :, :n])
                match_src[l, b, cols] = rows
        return match_src

    def level_losses(self, pred_logits, pred_points, tgt_labels, tgt_points,
                     tgt_valid, match_src, num_points):
        b, q, c = pred_logits.shape
        match_src = match_src.long()
        # the matched targets' classes as a (B, Q) map of num_classes. Only
        # valid slots may write: padded ones all carry query 0, and a
        # scatter with duplicate indices has no defined order, so they go to
        # a spare column Q that is cut off again.
        slot = torch.where(tgt_valid, match_src, q)
        cls = torch.where(tgt_valid, tgt_labels.long(), self.num_classes)
        matched_map = torch.full((b, q + 1), self.num_classes,
                                 dtype=torch.long, device=pred_logits.device)
        matched_map = matched_map.scatter(1, slot, cls)[:, :q]
        onehot = F.one_hot(matched_map, self.num_classes + 1)[..., :-1].to(
            pred_logits.dtype)
        loss_ce = sigmoid_focal_loss(pred_logits, onehot, num_points,
                                     self.focal_alpha) * q

        src_points = pred_points.gather(
            1, match_src[..., None].expand(-1, -1, pred_points.shape[-1]))
        l1 = (src_points - tgt_points).abs().sum(-1)
        loss_point = torch.where(tgt_valid, l1, 0.0).sum() / num_points

        card_pred = (pred_logits.argmax(-1) != c - 1).sum(1).float()
        card_err = (card_pred - tgt_valid.sum(1)).abs().mean()
        return {"loss_ce": loss_ce, "loss_point": loss_point,
                "cardinality_error": card_err}

    def losses(self, outputs, tgt_labels, tgt_points, tgt_valid, match_src,
               group=None):
        """match_src (L, B, T) -> (the weighted total, the loss dict).

        The losses are sums over the batch divided by the number of target
        points. With `group`, the data group of a rank holding a share of
        the batch, that number is the whole batch's, max(N, 1), over the
        group's size (DETR's convention), so that the mean over the ranks
        that DistributedDataParallel takes is the one-process loss and
        gradient; it stays a device tensor."""
        num_points = tgt_valid.sum().float()
        if group is not None:
            num_points = all_reduce_(num_points, group)
        num_points = num_points.clamp(min=1.0)
        if group is not None:
            num_points = num_points / dist.get_world_size(group)
        levels = _levels(outputs)
        loss_dict = {}
        n_aux = len(levels) - 1
        for l, lv in enumerate(levels):
            d = self.level_losses(lv["pred_logits"], lv["pred_points"],
                                  tgt_labels, tgt_points, tgt_valid,
                                  match_src[l], num_points)
            if l == n_aux:
                loss_dict.update(d)
            else:
                loss_dict.update({f"{k}_{l}": v for k, v in d.items()})
        total = sum(loss_dict[k] * w for k, w in self.weight_dict.items()
                    if k in loss_dict)
        return total, loss_dict


def build_weight_dict(cls_loss_coef=2, point_loss_coef=5, dec_layers=6,
                      aux_loss=True):
    weight_dict = {"loss_ce": cls_loss_coef, "loss_point": point_loss_coef}
    if aux_loss:
        aux = {}
        for i in range(dec_layers - 1):
            aux.update({f"{k}_{i}": v for k, v in weight_dict.items()})
        weight_dict.update(aux)
    return weight_dict


def to_numpy(a) -> np.ndarray:
    """A tensor (on any device, any float type) or anything numpy reads, as
    a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


class PostProcess:
    """The 100 highest sigmoid scores -> absolute points, on the host."""

    def __call__(self, outputs, target_sizes):
        out_logits = to_numpy(outputs["pred_logits"])
        out_point = to_numpy(outputs["pred_points"])
        bsz, q, c = out_logits.shape
        prob = 1 / (1 + np.exp(-out_logits))
        flat = prob.reshape(bsz, -1)
        k = min(100, flat.shape[1])
        topk_idx = np.argsort(-flat, axis=1)[:, :k]
        scores = np.take_along_axis(flat, topk_idx, axis=1)
        topk_points = topk_idx // c
        labels = topk_idx % c
        results = []
        for b in range(bsz):
            h, w = target_sizes[b]
            pts = out_point[b, topk_points[b]][:, :2] * np.array([w, h])
            results.append({"scores": scores[b], "labels": labels[b],
                            "points": pts})
        return results
