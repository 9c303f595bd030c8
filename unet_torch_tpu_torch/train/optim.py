"""Optimizers and LR schedules (counterpart of unet_torch_tpu/train/optim.py).

The reference's semantics, which the JAX package rebuilds in optax and torch
has natively:
  * Adam(lr, weight_decay, eps 1e-8): the decay is added to the gradient
    before the Adam update (L2, not AdamW), as `_adam_l2`;
  * SGD(lr, momentum 0.9, weight_decay): heavy-ball momentum on the decayed
    gradient, as `_sgd_momentum`;
  * optional global-norm gradient clipping before both (`clip_max_norm`, off
    by default), kept on the optimizer's param groups and applied by the
    train step;
  * poly LR decay per iteration and ReduceLROnPlateau, computed on the host.
"""

from __future__ import annotations

import torch


def make_optimizer(name: str, params, lr: float, weight_decay: float = 0.0,
                   momentum: float = 0.9,
                   clip_max_norm: float = 0.0) -> torch.optim.Optimizer:
    params = list(params)
    if name == "Adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay)
    elif name == "SGD":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f'Invalid optimizer "{name}"')
    for group in opt.param_groups:
        group["clip_max_norm"] = clip_max_norm
    return opt


def clip_gradients(opt: torch.optim.Optimizer) -> None:
    """Global-norm clipping of every gradient the optimizer holds, when its
    `clip_max_norm` is set (the JAX package's optax.clip_by_global_norm)."""
    max_norm = opt.param_groups[0].get("clip_max_norm", 0.0)
    if max_norm:
        params = [p for g in opt.param_groups for p in g["params"]
                  if p.grad is not None]
        torch.nn.utils.clip_grad_norm_(params, max_norm)


def poly_lr(base_lr: float, iter_num: int, max_iterations: int,
            power: float = 0.9) -> float:
    """Poly decay: base_lr * (1 - it/max_it)^0.9."""
    frac = max(0.0, 1.0 - iter_num / max_iterations)
    return base_lr * frac ** power


class ReduceLROnPlateau:
    """Host-side plateau scheduler with the reference's settings (mode min or
    max, factor 0.5, patience 30, min_lr 1e-5)."""

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.5,
                 patience: int = 30, min_lr: float = 1e-5):
        self.lr = base_lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = None
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        improved = (self.best is None or
                    (metric < self.best if self.mode == "min" else
                     metric > self.best))
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
