"""The loss zoo (counterpart of unet_torch_tpu/losses/functional.py), without
the topological losses.

`pred` is NHWC logits (B, H, W, C), as in the JAX package; `target` is
(B, H, W) class indices or a binary map (any numeric dtype), or (B, H, W, C)
for multi-channel regression. Everything is computed in f32, whatever the
logits' dtype, and returns a 0-d f32 tensor.

The Hausdorff-DT loss takes its distance fields from the exact squared
Euclidean distance transform, two min-plus products per mask
(kernels/minplus.py: the Hopper kernel on a CUDA tensor). All masks of a
step go through two launches. The fields are constants of the loss and are
computed under `no_grad`.

The JAX package's `*_planes_folded` family evaluates the same values on
W-folded class planes for the TPU's fused head and is not carried over;
`dice_bce_mc_loss` is also computed there on per-class planes for C <= 8
(`_dice_bce_mc_planes`), which is the same value summed in another order.

Data-parallel training: `group` is the data group of a rank that holds a
share of the batch (core/mesh.py), None in one process. The losses whose
value is not a mean over the batch of per-image terms are formed from sums
over the whole batch (core/dist.py::all_reduce_sum, whose backward sums the
gradients too), as the JAX package's GSPMD step forms them over the global
batch: the multiclass Dice sums, the top-k selections of `TopK` and
`BCE_HEM`, the Tversky sums, the active contour's sums and the root of
`rmse`. Every rank then holds the whole batch's value, and the mean of the
ranks' gradients that DistributedDataParallel takes is the one-process
gradient. The means over the batch (CE, BCE, focal, mse, l1, the per-image
binary Dice, the Hausdorff and topo losses) are the mean of the ranks'
means, which DDP's mean already gives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from unet_torch_tpu_torch.core.dist import all_gather_dim, all_reduce_sum
from unet_torch_tpu_torch.kernels.minplus import minplus


def sigmoid_bce_with_logits(logits, labels):
    """Numerically stable BCEWithLogits, per element:
    max(x, 0) - x z + log(1 + exp(-|x|))."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


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


def _global_topk_mean(select_by, values, k_div: int | None, k: int | None,
                      group):
    """The mean of `values` (flat) at the k largest entries of `select_by`
    over the whole batch (k = n // k_div, or `k`): every rank gathers the
    detached keys, selects globally and sums its own selected values."""
    if group is None:
        n = values.shape[0]
        _, idx = torch.topk(select_by, n // k_div if k is None else k)
        return torch.mean(values[idx])
    keys = all_gather_dim(select_by.detach(), group, 0)
    n = keys.shape[0]
    count = n // k_div if k is None else k
    _, idx = torch.topk(keys, count)
    local = values.shape[0]
    start = dist.get_rank(group) * local
    mine = torch.zeros(n, dtype=torch.bool, device=values.device)
    mine[idx] = True
    mine = mine[start:start + local]
    return all_reduce_sum(torch.where(mine, values, 0.0).sum(), group) / count


def multiclass_dice_loss(pred, target, num_classes: int, weights=None,
                         softmax: bool = False, group=None):
    """DiceLoss: one-hot target, per-class soft dice with squared
    denominators, smooth 1e-5, mean over classes (or weighted sum / C); the
    sums over the whole batch of `group`'s ranks."""
    pred = pred.float()
    if softmax:
        pred = torch.softmax(pred, dim=-1)
    onehot = F.one_hot(target.long(), num_classes).float()
    smooth = 1e-5
    sums = all_reduce_sum(torch.stack([
        torch.sum(pred * onehot, dim=(0, 1, 2)),
        torch.sum(pred * pred, dim=(0, 1, 2)),
        torch.sum(onehot * onehot, dim=(0, 1, 2))]), group)
    intersect, z, y = sums
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


def dice_bce_mc_loss(pred, target, num_classes: int, bce_weight: float = 0.5,
                     group=None):
    """dice_bce_mc, the flagship: bce_weight * CE + (1 - bce_weight) *
    DiceLoss(softmax)."""
    ce = softmax_cross_entropy(pred, target, num_classes)
    dice = multiclass_dice_loss(pred, target, num_classes, softmax=True,
                                group=group)
    return bce_weight * ce + (1.0 - bce_weight) * dice


def dice_score(pred, target, num_classes: int | None = None, group=None):
    """Dice coefficient (higher is better): the `dice_score(_mc)` metric."""
    if num_classes and num_classes > 1:
        return 1.0 - multiclass_dice_loss(pred, target, num_classes,
                                          softmax=True, group=group)
    return 1.0 - binary_dice_loss(pred, target)


# ---------------------------------------------------------------------------
# BCE variants
# ---------------------------------------------------------------------------

def bce_loss(pred, target):
    """BCEWithLogits, mean."""
    return torch.mean(sigmoid_bce_with_logits(_squeeze_last(pred).float(),
                                              target.float()))


def topk_bce_loss(pred, target, topk: int = 2, group=None):
    """TopKLoss: BCE over the 1/topk fraction of pixels with the lowest
    ground-truth probability (hard-example mining), over the whole batch."""
    logits = _squeeze_last(pred).float().reshape(-1)
    labels = target.float().reshape(-1)
    fg = torch.sigmoid(logits)
    gt_prob = torch.where(labels > 0.5, fg, 1.0 - fg)
    return _global_topk_mean(-gt_prob, sigmoid_bce_with_logits(logits, labels),
                             topk, None, group)


def bce_hem_loss(pred, target, k: int = 500, batch_base: bool = False,
                 group=None):
    """BCE_HEM: the mean of the top-k pixel losses of the whole batch (or of
    the top-2 batch items' mean losses)."""
    ce = sigmoid_bce_with_logits(_squeeze_last(pred).float(), target.float())
    if batch_base:
        per_item = torch.mean(ce, dim=(1, 2))
        return _global_topk_mean(per_item, per_item, None, 2, group)
    flat = ce.reshape(-1)
    return _global_topk_mean(flat, flat, None, k, group)


def focal_loss(pred, target, alpha: float = 0.25, gamma: float = 2.0):
    """FocalLoss: alpha (1 - pt)^gamma BCE, mean."""
    ce = sigmoid_bce_with_logits(_squeeze_last(pred).float(), target.float())
    pt = torch.exp(-ce)
    return torch.mean(alpha * (1.0 - pt) ** gamma * ce)


# ---------------------------------------------------------------------------
# regression losses
# ---------------------------------------------------------------------------

def mse_loss(pred, target):
    return torch.mean((_squeeze_last(pred).float()
                       - _squeeze_last(target).float()) ** 2)


def mse_mc_loss(pred, target):
    return torch.mean((pred.float() - target.float()) ** 2)


def rmse_loss(pred, target, group=None):
    """The root of the whole batch's mean square."""
    sq = (pred.float() - target.float()) ** 2
    if group is None:
        return torch.sqrt(torch.mean(sq))
    total = all_reduce_sum(sq.sum(), group)
    return torch.sqrt(total / (sq.numel() * dist.get_world_size(group)))


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred.float() - target.float()))


# ---------------------------------------------------------------------------
# dice and Tversky
# ---------------------------------------------------------------------------

def dice_bce_loss(pred, target, bce_weight: float = 0.5):
    """dice_bce: bce_weight * BCEWithLogits + (1 - bce_weight) *
    BinaryDice."""
    return (bce_weight * bce_loss(pred, target)
            + (1.0 - bce_weight) * binary_dice_loss(pred, target))


def log_cosh_dice_loss(pred, target, num_classes: int, group=None):
    x = multiclass_dice_loss(pred, target, num_classes, softmax=True,
                             group=group)
    return torch.log((torch.exp(x) + torch.exp(-x)) / 2.0)


def focal_tversky_loss(pred, target, smooth: float = 1.0, alpha: float = 0.5,
                       beta: float = 0.5, gamma: float = 1.0, group=None):
    """FocalTverskyLoss: binary (1 channel, sigmoid) or the mean over the
    classes of a softmax; tp, fp and fn summed over the whole batch."""
    pred = pred.float()
    num_classes = pred.shape[-1]
    if num_classes == 1:
        p = torch.sigmoid(pred[..., 0]).reshape(-1)
        t = target.float().reshape(-1)
        dims = None
    else:
        p = torch.softmax(pred, dim=-1).reshape(-1, num_classes)
        t = F.one_hot(target.long().reshape(-1), num_classes).float()
        dims = 0
    tp, fp, fn = all_reduce_sum(torch.stack([
        torch.sum(p * t, dim=dims), torch.sum((1.0 - t) * p, dim=dims),
        torch.sum(t * (1.0 - p), dim=dims)]), group)
    tv = (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    return torch.mean((1.0 - tv) ** gamma)


# ---------------------------------------------------------------------------
# Hausdorff losses
# ---------------------------------------------------------------------------

_EDT_BIG = 1e12


def euclidean_distance_transform_sq(mask):
    """Exact squared EDT of binary masks (H, W) or (B, H, W): the squared
    distance of each pixel to the nearest zero.

    Separable: EDT2(i, j) = min_l [f(i, l) + (j - l)^2] with
    f(i, l) = min_k [(i - k)^2 + INF (mask > 0)(k, l)], two min-plus products
    against the squared-distance tables, which the whole stack shares (one
    launch each on a CUDA tensor). Equals
    scipy.ndimage.distance_transform_edt squared; a mask without a zero
    gives 1e12 everywhere. No gradient."""
    with torch.no_grad():
        h, w = mask.shape[-2:]
        dev = mask.device
        # 0 where the mask is background (a distance source), INF elsewhere
        g = torch.where(mask > 0, _EDT_BIG, 0.0).to(torch.float32)
        ii = torch.arange(h, dtype=torch.float32, device=dev)
        dk2 = (ii[:, None] - ii[None, :]) ** 2      # (i, k)
        f = minplus(dk2, g)                          # (i, l)
        jj = torch.arange(w, dtype=torch.float32, device=dev)
        dl2 = (jj[:, None] - jj[None, :]) ** 2      # (l, j)
        d2 = minplus(f, dl2)                         # (i, j)
        return torch.clamp(d2, max=_EDT_BIG)


def _distance_field(img):
    """HausdorffDTLoss.distance_field for a stack (B, H, W): the distance
    inside the foreground plus the distance inside the background of the
    0.5-thresholded map; zero for an image without foreground. The flag
    stays on the device."""
    fg = (img > 0.5).float()
    d = torch.sqrt(euclidean_distance_transform_sq(
        torch.cat([1.0 - fg, fg])))
    field = d[:fg.shape[0]] + d[fg.shape[0]:]
    any_fg = torch.amax(fg, dim=(1, 2), keepdim=True) > 0
    return torch.where(any_fg, field, torch.zeros_like(field))


def hausdorff_dt_loss(pred, target, alpha: float = 0.2):
    """HausdorffDTLoss: (sigmoid(pred) - target)^2 weighted by pred_dt^alpha +
    target_dt^alpha. The distance fields are constants: the prediction's and
    the target's masks go through the distance transform together, under
    no_grad."""
    p = torch.sigmoid(_squeeze_last(pred).float())
    t = target.float()
    with torch.no_grad():
        fields = _distance_field(torch.cat([p, t]))
        distance = (fields[:p.shape[0]] ** alpha
                    + fields[p.shape[0]:] ** alpha)
    return torch.mean((p - t) ** 2 * distance)


def hausdorff_er_loss(pred, target, alpha: float = 2.0, erosions: int = 10):
    """HausdorffERLoss, the morphological-erosion Hausdorff loss: bound =
    (sigmoid(pred) - target)^2; `erosions` times: convolve with the
    0.2-weighted 3x3 cross, soft-threshold at 0.5, min-max normalise,
    accumulate erosion * (k + 1)^alpha.

    As in the JAX package (and the reference, which erodes under no_grad)
    the bound is a constant, so the value has a zero gradient with respect
    to `pred`; the zero is kept in the graph so that a train step can call
    backward on it."""
    p = torch.sigmoid(_squeeze_last(pred).float())
    t = target.float()
    with torch.no_grad():
        bound = ((p - t) ** 2)[:, None]              # (B, 1, H, W)
        cross = torch.tensor([[0.0, 1.0, 0.0], [1.0, 1.0, 1.0],
                              [0.0, 1.0, 0.0]], device=p.device) * 0.2
        kernel = cross[None, None]
        acc = torch.zeros_like(bound)
        for k in range(erosions):
            dil = F.conv2d(bound, kernel, padding=1)
            ero = torch.clamp(dil - 0.5, min=0.0)
            lo = torch.amin(ero, dim=(1, 2, 3), keepdim=True)
            hi = torch.amax(ero, dim=(1, 2, 3), keepdim=True)
            ptp = hi - lo
            ero = torch.where(
                ptp > 0, (ero - lo) / torch.where(ptp > 0, ptp,
                                                  torch.ones_like(ptp)), ero)
            acc = acc + ero * (k + 1.0) ** alpha
            bound = ero
        value = torch.mean(acc)
    return value + torch.sum(p * 0.0)


# ---------------------------------------------------------------------------
# active contour
# ---------------------------------------------------------------------------

def active_contour_loss(pred, target, smooth: float = 1e-8, group=None):
    """ActiveContourLoss: contour length plus the two region terms, on NHWC
    logits (spatial axes 1 and 2), each summed over the whole batch."""
    p = torch.sigmoid(pred.float())
    x = p[:, 1:, :, :] - p[:, :-1, :, :]
    y = p[:, :, 1:, :] - p[:, :, :-1, :]
    delta_x = x[:, 1:, :-2, :] ** 2
    delta_y = y[:, :-2, 1:, :] ** 2
    p0 = p[..., 0]
    t0 = (target if target.dim() == 3 else target[..., 0]).float()
    length, inside, outside = all_reduce_sum(torch.stack([
        torch.sum(torch.sqrt(torch.abs(delta_x + delta_y) + smooth)),
        torch.sum(p0 * (t0 - 1.0) ** 2),
        torch.sum((1.0 - p0) * t0 ** 2)]), group)
    return length + torch.abs(inside) + torch.abs(outside)


# ---------------------------------------------------------------------------
# multitask uncertainty
# ---------------------------------------------------------------------------

def multitask_uncertainty_loss(loss_values, log_vars, regression_flags):
    """Learned log-variance weighting (Kendall et al.): the sum over tasks
    of coeff_i loss_i + log sigma_i, coeff = 1 / (2 sigma^2) for a regression
    task and 1 / sigma^2 otherwise."""
    total = 0.0
    for loss_i, log_var, is_reg in zip(loss_values, log_vars,
                                       regression_flags):
        std = torch.exp(log_var) ** 0.5
        coeff = 1.0 / (2.0 * std ** 2) if is_reg else 1.0 / std ** 2
        total = total + coeff * loss_i + torch.log(std)
    return total
