"""Loss dispatch by the reference's config strings (counterpart of
unet_torch_tpu/losses/__init__.py::calc_loss).

The port carries the main path's keys: `CE`, `dice_bce_mc` (the loss of
configs/segmentation_mc.yml and configs/transunet.yml, which also use it as
their accuracy), `dice_score_mc` and `dice_score`. Every other key of the
JAX dispatch raises NotImplementedError naming its ROADMAP.md item
(core/not_ported.py); an unknown key raises KeyError, as in the JAX package.
"""

from __future__ import annotations

import functools

from unet_torch_tpu_torch.core import not_ported
from unet_torch_tpu_torch.losses.functional import (
    dice_bce_mc_loss,
    dice_score,
    softmax_cross_entropy,
)

_DISPATCH = {
    "CE": lambda p, t, w, n: softmax_cross_entropy(p, t, n),
    "dice_bce_mc": lambda p, t, w, n: dice_bce_mc_loss(p, t, n, w),
    "dice_score": lambda p, t, w, n: dice_score(p, t),
    "dice_score_mc": lambda p, t, w, n: dice_score(p, t, n),
}


def _check_key(loss_type: str) -> None:
    if loss_type in _DISPATCH:
        return
    not_ported.check(not_ported.LOSSES, "loss_type", loss_type)
    raise KeyError(f"Unknown loss_type {loss_type!r}; known: "
                   f"{sorted(_DISPATCH)}")


def calc_loss(pred, target, bce_weight: float = 0.5, loss_type: str = "CE",
              num_classes: int = 2):
    """String-dispatch loss; NHWC logits, f32 result."""
    _check_key(loss_type)
    return _DISPATCH[loss_type](pred, target, bce_weight, num_classes)


def get_loss_fn(loss_type: str, num_classes: int, bce_weight: float = 0.5):
    """A (pred, target) -> loss callable; raises at once on a key the port
    does not have."""
    _check_key(loss_type)
    return functools.partial(calc_loss, bce_weight=bce_weight,
                             loss_type=loss_type, num_classes=num_classes)
