"""Loss dispatch by the reference's config strings (counterpart of
unet_torch_tpu/losses/__init__.py::calc_loss).

The port carries every key of the JAX dispatch, the topological names
(`TopoLoss`, `MyTopoLoss*` on the global loss, `TopoCount` on the localized
one; losses/topo.py) included; an unknown key raises KeyError, as in the JAX
package, and so do the trainer's loop names that are no loss
(`myTopoLoss`, `TopoCount2`, `TopoLoss2`). `CLASS_NUMBER` /
`set_class_number` are the reference-compatible module global that
`calc_loss` falls back on when no `num_classes` is passed.
"""

from __future__ import annotations

import functools

from unet_torch_tpu_torch.core import not_ported
from unet_torch_tpu_torch.losses.functional import (
    active_contour_loss,
    bce_hem_loss,
    bce_loss,
    binary_dice_loss,
    dice_bce_loss,
    dice_bce_mc_loss,
    dice_score,
    focal_loss,
    focal_tversky_loss,
    hausdorff_dt_loss,
    hausdorff_er_loss,
    l1_loss,
    log_cosh_dice_loss,
    mse_loss,
    mse_mc_loss,
    rmse_loss,
    softmax_cross_entropy,
    topk_bce_loss,
)
from unet_torch_tpu_torch.losses.topo import topo_loss, topocount_loss

# reference-compatible module global (the reference's train.py writes it)
CLASS_NUMBER: int = 2


def set_class_number(n: int) -> None:
    global CLASS_NUMBER
    CLASS_NUMBER = int(n)


_DISPATCH = {
    "BCE": lambda p, t, w, n, g: bce_loss(p, t),
    "TopK": lambda p, t, w, n, g: topk_bce_loss(p, t, group=g),
    "BCE_HEM": lambda p, t, w, n, g: bce_hem_loss(p, t, group=g),
    "CE": lambda p, t, w, n, g: softmax_cross_entropy(p, t, n),
    "FL": lambda p, t, w, n, g: focal_loss(p, t, gamma=2.0),
    "mse": lambda p, t, w, n, g: mse_loss(p, t),
    "mseMC": lambda p, t, w, n, g: mse_mc_loss(p, t),
    "rmse": lambda p, t, w, n, g: rmse_loss(p, t, group=g),
    "l1loss": lambda p, t, w, n, g: l1_loss(p, t),
    "dice": lambda p, t, w, n, g: binary_dice_loss(p, t),
    "dice_bce": lambda p, t, w, n, g: dice_bce_loss(p, t, w),
    "dice_bce_mc": lambda p, t, w, n, g: dice_bce_mc_loss(p, t, n, w, group=g),
    "dice_score": lambda p, t, w, n, g: dice_score(p, t),
    "dice_score_mc": lambda p, t, w, n, g: dice_score(p, t, n, g),
    "log_cosh_dice_loss": lambda p, t, w, n, g: log_cosh_dice_loss(p, t, n, g),
    "HausdorffDTLoss": lambda p, t, w, n, g: hausdorff_dt_loss(p, t),
    "HausdorffERLoss": lambda p, t, w, n, g: hausdorff_er_loss(p, t),
    "ActiveContourLoss": lambda p, t, w, n, g: active_contour_loss(
        p, t, group=g),
    "Tversky": lambda p, t, w, n, g: focal_tversky_loss(
        p, t, alpha=0.4, beta=0.6, group=g),
    # the global (Hu-style) persistence matching against a binary mask
    "TopoLoss": lambda p, t, w, n, g: topo_loss(p, t),
    "MyTopoLoss1": lambda p, t, w, n, g: topo_loss(p, t),
    "MyTopoLoss2": lambda p, t, w, n, g: topo_loss(p, t),
    "MyTopoLossGraph": lambda p, t, w, n, g: topo_loss(p, t),
    "MyTopoLossVR": lambda p, t, w, n, g: topo_loss(p, t),
    # the localized (Abousamra-style) per-window constraint against a dot map
    "TopoCount": lambda p, t, w, n, g: topocount_loss(p, t),
}

# the reference trainer's topo names (its warm-up loop's dispatch adds
# TopoCount2 and TopoLoss2; train/trainer.py::TOPO_LOSS_NAMES)
TOPO_LOSSES = {"TopoLoss", "MyTopoLoss1", "MyTopoLoss2", "MyTopoLossGraph",
               "MyTopoLossVR", "TopoCount", "myTopoLoss"}


def _check_key(loss_type: str) -> None:
    if loss_type in _DISPATCH:
        return
    not_ported.check(not_ported.LOSSES, "loss_type", loss_type)
    raise KeyError(f"Unknown loss_type {loss_type!r}; known: "
                   f"{sorted(_DISPATCH)}")


def calc_loss(pred, target, bce_weight: float = 0.5, loss_type: str = "mse",
              num_classes: int | None = None, group=None):
    """String-dispatch loss; NHWC logits, f32 result. `group`: the data
    group of a rank holding a share of the batch (losses/functional.py),
    None in one process."""
    _check_key(loss_type)
    n = num_classes if num_classes is not None else CLASS_NUMBER
    return _DISPATCH[loss_type](pred, target, bce_weight, n, group)


def get_loss_fn(loss_type: str, num_classes: int, bce_weight: float = 0.5,
                group=None):
    """A (pred, target) -> loss callable; raises at once on a key the port
    does not have."""
    _check_key(loss_type)
    return functools.partial(calc_loss, bce_weight=bce_weight,
                             loss_type=loss_type, num_classes=num_classes,
                             group=group)
