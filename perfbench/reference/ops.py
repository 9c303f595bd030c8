"""The products of the reference models, in a stated precision.

`Ops("f32")` computes convolutions, linear layers and matmuls in float32.
`Ops("fp8")` rounds each operand and each result of those products to
float8 e4m3 with one scale a tensor (its largest magnitude onto e4m3's
448) and accumulates in float32, and in the backward rounds the gradient
reaching each of those points to float8 e5m2 (largest 57344), as a
program that trains with its products and activations in float8 would:
the control, one precision step below the bfloat16 the configurations
state (whose program rounds the same operands and results to bfloat16).
`Ops("bf16")` rounds the same operands, results and gradients to
bfloat16, as the program's autocast does, and `Ops("f64")` runs the model
in float64: two witnesses for the readings (readings.py), which no run of
the benchmark computes. Every reference model also records the calls that
the port's kernels would make (`records`), which the FLOP and bound
arithmetic reads."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _round(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    amax = t.abs().amax().float()
    scale = torch.where(amax > 0, amax / largest, torch.ones_like(amax))
    return (t / scale).to(dtype).to(t.dtype) * scale


class _FP8(torch.autograd.Function):
    """e4m3 going forward; the gradient coming back rounded to e5m2, as
    float8 training keeps its gradients."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class _BF16(torch.autograd.Function):
    """bfloat16 going forward and coming back."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


ROUND = {"fp8": _FP8.apply, "bf16": _BF16.apply}
DTYPE = {"f64": torch.float64}


class Ops:
    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "f64", *ROUND):
            raise ValueError(f"no reference precision {precision!r}")
        self.precision = precision
        self.dtype = DTYPE.get(precision, torch.float32)
        self._round = ROUND.get(precision)
        self.records = []

    def q(self, t):
        return t if self._round is None else self._round(t)

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride, padding))

    def conv_transpose2d(self, x, w, b, stride):
        return self.q(F.conv_transpose2d(self.q(x), self.q(w), b, stride))

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def matmul(self, a, b):
        return self.q(torch.matmul(self.q(a), self.q(b)))

    def record(self, kind: str, shape: tuple):
        self.records.append((kind, tuple(int(s) for s in shape)))
