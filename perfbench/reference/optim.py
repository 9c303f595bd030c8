"""The configurations' optimizers on a dict of float32 leaves, and the
poly LR. Both add the weight decay to the gradient before their update
(L2, not decoupled): Adam (betas 0.9, 0.999, eps 1e-8, bias-corrected),
SGD with heavy-ball momentum 0.9 (the buffer starts at the first
gradient)."""

from __future__ import annotations

import math

import torch


def poly_lr(base_lr: float, it: int, max_it: int, power: float = 0.9):
    return base_lr * max(0.0, 1.0 - it / max_it) ** power


class Optimizer:
    def __init__(self, name: str, weight_decay: float):
        if name not in ("Adam", "SGD"):
            raise ValueError(f"no reference optimizer {name!r}")
        self.name = name
        self.wd = weight_decay
        self.t = 0
        self.state = {}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> dict:
        """Update `params` in place; returns the gradients as the update
        took them (decay added)."""
        self.t += 1
        taken = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            if self.name == "SGD":
                buf = self.state.get(k)
                buf = g.clone() if buf is None else buf.mul_(0.9).add_(g)
                self.state[k] = buf
                p.sub_(lr * buf)
                continue
            m, v = self.state.get(k, (torch.zeros_like(p),
                                      torch.zeros_like(p)))
            m.mul_(0.9).add_(0.1 * g)
            v.mul_(0.999).add_(0.001 * g * g)
            self.state[k] = (m, v)
            denom = v.sqrt() / math.sqrt(1 - 0.999 ** self.t) + 1e-8
            p.sub_(lr / (1 - 0.9 ** self.t) * m / denom)
        return taken
