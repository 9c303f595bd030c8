"""Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates) and
the least times of the kernels whose rooflines the benchmark reads: the
fused conv3x3 + BN + ReLU and the attention forward and backward. A frozen
copy of the port's smoke-test arithmetic, so that an edit there cannot move
the yardstick."""

from __future__ import annotations

PEAK_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
PEAK_F32 = 67e12  # FLOP/s outside the tensor cores (an FMA counts two)
PEAK_BYTES = 3.35e12  # B/s, HBM3
# exponentials a second: 16 results a clock an SM from the special-function
# units against the 256 f32 operations a clock behind PEAK_F32
PEAK_EXP = PEAK_F32 / 256 * 16


def conv_bound(shapes, batch: int):
    """(least seconds, what bounds most of it) of bf16 fused convs at
    `shapes`, a list of (h, cin, cout) square maps, summed: 2 * 9 * Cin *
    Cout operations a pixel on the tensor cores against x, w, scale and
    bias read once and y written once."""
    total, by = 0.0, {"operations": 0.0, "bytes": 0.0}
    for h, cin, cout in shapes:
        pixels = batch * h * h
        ops_s = 2 * 9 * cin * cout * pixels / PEAK_BF16
        bytes_s = (2 * pixels * (cin + cout) + 2 * 9 * cin * cout
                   + 8 * cout) / PEAK_BYTES
        kind = "operations" if ops_s >= bytes_s else "bytes"
        by[kind] += max(ops_s, bytes_s)
        total += max(ops_s, bytes_s)
    return total, max(by, key=by.get)


def attention_bound(shape, backward: bool = False, lse: bool = False):
    """(least seconds, "operations" or "bytes", which unit) of one bf16
    attention call at `shape` = (b, heads, nq, nk, dqk, dv): the largest of
    three times. Tensor cores: the forward's QK^T and PV; the backward's
    five products (S, dP, dV, dK, dQ). Exp unit: one exponential a score.
    Bytes: q, k, v and o (and the f32 lse) once; the backward also reads g
    and writes dq, dk and dv."""
    b, h, nq, nk, dqk, dv = shape
    products = (3 * dqk + 2 * dv) if backward else (dqk + dv)
    mma_s = 2 * b * h * nq * nk * products / PEAK_BF16
    exp_s = b * h * nq * nk / PEAK_EXP
    qkvo = 2 * b * h * (nq * dqk + nk * dqk + nk * dv + nq * dv)
    nbytes = qkvo + (4 * b * h * nq if lse or backward else 0)
    if backward:
        nbytes += 2 * b * h * nq * dv + 2 * b * h * (nq * dqk + nk * dqk
                                                      + nk * dv)
    bytes_s = nbytes / PEAK_BYTES
    return max((mma_s, "operations", "tensor cores"),
               (exp_s, "operations", "exp unit"),
               (bytes_s, "bytes", "device memory"))
