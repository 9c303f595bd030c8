"""Attention: the Hopper flash kernels and their plain PyTorch versions.

The JAX package's Pallas kernels (unet_torch_tpu/kernels/attention.py) are
ported as four hand-written CUDA sources:

  csrc/flash_attention_fwd.cu  `_attention_pallas` and `_attention_flash`
                               (eval forward), `_dropout_flash_fwd` (train
                               forward: o, the row log-sum-exp, dropout on
                               the probabilities)
  csrc/flash_attention_bwd.cu  `_dropout_flash_bwd` and `_dropout_flash_bwd1`
                               (dq, dk, dv), also the backward of the eval
                               kernels' custom VJPs
                               Both hold three kernels, and `attention_route`
                               says which a call launches from its dtype and
                               head widths alone: bf16 on wgmma + TMA at the
                               models' widths, bf16 on mma.sync at any other,
                               f32 on the CUDA cores.
  csrc/dropout_keep_mask.cu    the keep-mask probe of
                               benchmarks/tpu_dfa_check.py
  csrc/packed2_attention_fwd.cu  the packed two-head forward probe of
                               benchmarks/r8_attn_ab.py (`packed2_attention`)

    o = softmax(q @ k^T * scale + bias) @ v

Layouts follow the JAX package: q and k are (B, H, N, Dqk), v is
(B, H, Nk, Dv), the result (B, H, Nq, Dv) in q's dtype. Dqk may differ from
Dv (CLTR's cross-attention). A key-padding mask (B, Nk), True on padding,
becomes an additive (B, Nk) f32 bias of -1e30, as `_attention_pallas` takes
it; a batch row whose keys are all padding then gets the mean of its Nk rows
of v in every version here. (The JAX package's einsum fallback gives NaN for
such a row, and `_attention_flash` averages over its zero-padded columns
too.) The train forward subtracts each batch row's largest bias after adding
it: no probability changes, but the log-sum-exp of such a row stays log Nk,
so that the backward recomputes its probabilities.

Dropout (train) is inverted dropout on the normalised probabilities, with
the JAX package's counter-hash mask (`dropout_keep`): a pure function of
(seed, batch*head, global row, global column) and of the padded key count
`dfa_nk_p`, bit for bit the mask of `_dropout_flash_fwd` in interpret mode.
The TPU's hardware-PRNG branch (`hw_prng`) is not carried over. A rank of a
data- or tensor-parallel step holds a share of the batch rows and heads,
and a rank of a spatially partitioned one a strip of the query rows (its
image rows' tokens, against the keys of every strip); the train calls take
its `offsets`, (b_off, h_off, h_total, q_off), and hash the batch*head of
the whole batch, (b + b_off) * h_total + h + h_off, and the query row of
the whole sequence, q_off + the call's row, so that its mask is its slice
of the one-process mask, bit for bit.

Every wrapper routes by the device of its tensors: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel, which raises on anything it does
not take. Each wrapper counts its kernel's launches in `.launches`.
`fused_attention` is differentiable: with autograd recording it runs the
train forward and backward kernels at rate 0; under `no_grad` it launches
the eval forward only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from unet_torch_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# which kernel of a source a call launches, as its C entry point numbers them
_ROUTE_CODE = {"f32": 0, "mma.sync": 1, "wgmma": 2}
# (Dqk, Dv) of the wgmma instances: the ViT, CLTR's two self-attentions and
# CLTR's cross-attention
WGMMA_WIDTHS = frozenset({(64, 64), (32, 32), (64, 32)})
# -1e30 marks padding keys, as in the JAX package
PAD_BIAS = -1e30
_U32 = 0xFFFFFFFF


def padding_bias(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """(B, Nk) bool, True on padding -> (B, Nk) f32 additive score bias."""
    zeros = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                        device=key_padding_mask.device)
    return zeros.masked_fill(key_padding_mask, PAD_BIAS)


def attention_probs(q, k, scale, bias=None):
    """The plain version's probabilities: softmax(q k^T * scale + bias) in
    f32, (B, H, Nq, Nk), from scores summed in f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    return torch.softmax(s, dim=-1)


def attention_reference(q, k, v, scale, bias=None):
    """q, k (B,H,Nq/Nk,Dqk), v (B,H,Nk,Dv), bias (B,Nk) f32 or None.

    Mirrors the Pallas kernels: f32 scores from q's dtype, f32 softmax, the
    probabilities rounded to v's dtype, the second product summed in f32 and
    rounded once to q's dtype."""
    p = attention_probs(q, k, scale, bias).to(v.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float())
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# The dropout mask: the counter hash of _mix32 / _dropout_keep
# ---------------------------------------------------------------------------

def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def dfa_nk_p(nk: int) -> int:
    """The key count padded as the JAX package's dropout flash kernels pad
    it (`_dfa_blocks`, then `_dropout_flash_fwd`'s block_k), which the mask
    hash takes as its row stride."""
    bk = min(1024 if nk >= 1024 else 512, _ceil_to(nk, 128))
    return _ceil_to(nk, bk)


def dropout_threshold(rate: float) -> int:
    """keep = hash >= threshold; P(keep) = 1 - rate."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c modulo 2**32 for int64 x in [0, 2**32): the constant is split
    into 16-bit halves so that no product leaves the int64 range."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's finaliser on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_keep(seed: int, n_bh: int, nq: int, nk: int, nk_p: int, thr: int,
                 *, row0: int = 0, device=None, bh=None) -> torch.Tensor:
    """The keep mask (n_bh, nq, nk) bool of batch*heads 0..n_bh-1 (or of the
    n_bh indices `bh`), query rows row0..row0+nq-1 and key columns
    0..nk-1: bit for bit JAX's `_dropout_keep(seed, bh, row0, 0, (nq, nk),
    nk_p, thr)`."""
    i64 = dict(dtype=torch.int64, device=device)
    bh = (torch.arange(n_bh, **i64) if bh is None
          else bh.to(**i64)).view(-1, 1, 1)
    row = torch.arange(row0, row0 + nq, **i64).view(1, -1, 1) & _U32
    col = torch.arange(nk, **i64).view(1, 1, -1)
    base = _mix32((seed & _U32) ^ _mul32(bh, 2654435761))
    h = _mix32(((_mul32(row, nk_p & _U32) + col) & _U32) ^ base)
    return h >= thr


# ---------------------------------------------------------------------------
# Plain versions of the train kernels
# ---------------------------------------------------------------------------

def _train_scores(q, k, scale, bias):
    """f32 scores with the bias added, then each batch row's largest bias
    taken off (the kernels' order: a -1e30 swallows the score first)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = (s + bias[:, None, None, :]) - bias.amax(dim=1)[:, None, None,
                                                            None]
    return s


def mask_offsets(offsets, h: int) -> tuple:
    """(b_off, h_off, h_total, q_off) of a call's batch rows, heads and
    query rows in the whole batch and sequence; None is the whole batch
    itself, (0, 0, h, 0), and a triple (b_off, h_off, h_total) starts at
    query row 0."""
    if offsets is None:
        return (0, 0, h, 0)
    offsets = tuple(int(o) for o in offsets)
    return offsets + (0,) * (4 - len(offsets))


def global_bh(b: int, h: int, offsets=None, device=None) -> torch.Tensor:
    """The (b * h,) flat batch*head indices of the whole batch that a call
    of b rows and h heads at `offsets` holds."""
    b_off, h_off, h_total, _ = mask_offsets(offsets, h)
    rows = torch.arange(b_off, b_off + b, device=device)
    heads = torch.arange(h_off, h_off + h, device=device)
    return (rows[:, None] * h_total + heads[None, :]).reshape(-1)


def _keep_mask(seed, rate, shape, nk_p, device, offsets=None):
    b, h, nq, nk = shape
    nk_p = dfa_nk_p(nk) if nk_p is None else nk_p
    keep = dropout_keep(seed, b * h, nq, nk, nk_p, dropout_threshold(rate),
                        row0=mask_offsets(offsets, h)[3], device=device,
                        bh=global_bh(b, h, offsets, device))
    return keep.view(b, h, nq, nk)


def attention_train_reference(q, k, v, scale, bias=None, seed=0, rate=0.0,
                              nk_p=None, offsets=None):
    """The train forward: (o (B,H,Nq,Dv) in q's dtype, lse (B*H, Nq) f32).

    Mirrors `_dropout_flash_fwd`: f32 scores, the row log-sum-exp (natural
    log) before dropout, inverted dropout with the counter-hash mask on the
    normalised probabilities, the probabilities rounded to v's dtype and the
    second product summed in f32. `nk_p` defaults to `dfa_nk_p(Nk)`;
    `offsets` place the call in the whole batch (`mask_offsets`)."""
    b, h, nq, _ = q.shape
    s = _train_scores(q, k, scale, bias)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if rate > 0.0:
        keep = _keep_mask(seed, rate, s.shape, nk_p, q.device, offsets)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype), lse.reshape(b * h, nq)


def attention_backward_reference(q, k, v, o, lse, g, scale, bias=None,
                                 seed=0, rate=0.0, nk_p=None, offsets=None):
    """(dq, dk, dv) of the train forward, from its (o, lse) and the output
    gradient g, as `_dropout_flash_bwd1` computes them: p recomputed from q,
    k and lse, the mask regenerated, D = rowsum(g * o) in f32, the products'
    operands in q's dtype with f32 sums, the results rounded once."""
    b, h, nq, _ = q.shape
    dt = q.dtype
    s = _train_scores(q, k, scale, bias)
    p = torch.exp(s - lse.reshape(b, h, nq, 1))
    gf = g.float()
    d = (gf * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, v.float())
    p_drop = p
    if rate > 0.0:
        keep = _keep_mask(seed, rate, s.shape, nk_p, q.device, offsets)
        inv_keep = 1.0 / (1.0 - rate)
        p_drop = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dp * inv_keep, 0.0)
    ds = (p * (dp - d)).to(dt).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p_drop.to(dt).float(), gf)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dq.to(dt), dk.to(dt), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def attention_route(dtype: torch.dtype, dqk: int, dv: int) -> str:
    """Which kernel of csrc/flash_attention_{fwd,bwd}.cu a call launches, a
    function of the dtype and the head widths alone: "f32" (CUDA cores) for
    float32; for bfloat16 "wgmma" at the width pairs of `WGMMA_WIDTHS`,
    compiled at their own widths, and "mma.sync" (widths padded to 64 or
    128) at every other pair `_check` takes."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"no attention kernel for {dtype}")
    return "wgmma" if (dqk, dv) in WGMMA_WIDTHS else "mma.sync"


def _load(name: str, nargs: list) -> ctypes.CDLL:
    lib = build.load(name)
    fn = getattr(lib, name)
    fn.argtypes = nargs
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float


@functools.cache
def _library() -> ctypes.CDLL:
    return _load("flash_attention_fwd",
                 [_P] * 7 + [_I] * 6 + [_F, _U, _U, _U, _F] + [_I] * 6 + [_P])


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    return _load("flash_attention_bwd",
                 [_P] * 13 + [_I] * 6 + [_F, _U, _U, _U, _F] + [_I] * 6 + [_P])


@functools.cache
def _mask_library() -> ctypes.CDLL:
    return _load("dropout_keep_mask", [_P, _I, _I, _I, _U, _U, _U, _U, _P])


@functools.cache
def _packed2_library() -> ctypes.CDLL:
    return _load("packed2_attention_fwd", [_P] * 4 + [_I] * 3 + [_F, _P])


def _raise_on(lib, name: str, err: int) -> None:
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")


def _check(q, k, v, bias, extra=()):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, N, D), got shape "
                             f"{tuple(t.shape)}")
    b, h, nq, dqk = q.shape
    nk, dv = k.shape[2], v.shape[3]
    if tuple(k.shape) != (b, h, nk, dqk):
        raise ValueError(f"k must be ({b}, {h}, Nk, {dqk}), got "
                         f"{tuple(k.shape)}")
    if tuple(v.shape) != (b, h, nk, dv):
        raise ValueError(f"v must be ({b}, {h}, {nk}, Dv), got "
                         f"{tuple(v.shape)}")
    for name, d in (("Dqk", dqk), ("Dv", dv)):
        if d % 16 or not 16 <= d <= 128:
            raise ValueError(f"{name} = {d}: the kernel takes multiples of 16 "
                             "from 16 to 128")
    if min(b, h, nq, nk) == 0:
        raise ValueError(f"empty input: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if b * h * nq >= 2**31 or b * h * nk >= 2**31:
        raise ValueError(f"B*H*N = {b * h * max(nq, nk)} does not fit the "
                         "kernel's 32-bit block index")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    tensors = [("q", q), ("k", k), ("v", v), *extra]
    if bias is not None:
        if tuple(bias.shape) != (b, nk) or bias.dtype != torch.float32:
            raise ValueError(f"bias must be float32 ({b}, {nk}), got "
                             f"{bias.dtype} {tuple(bias.shape)}")
        tensors.append(("bias", bias))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _cuda_only(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {t.device}")


def _bias_args(bias):
    if bias is None:
        return None, None, None
    bias_max = bias.amax(dim=1).contiguous()
    return bias_max, bias.data_ptr(), bias_max.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _flash_forward(q, k, v, scale, bias, lse, seed, rate, offsets=None):
    """Launch flash_attention_fwd; lse None is the eval call."""
    b, h, nq, dqk = q.shape
    nk, dv = k.shape[2], v.shape[3]
    o = torch.empty((b, h, nq, dv), dtype=q.dtype, device=q.device)
    keep_alive, bias_ptr, bias_max_ptr = _bias_args(bias)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, bias_max_ptr,
            o.data_ptr(), None if lse is None else lse.data_ptr(),
            b, h, nq, nk, dqk, dv, float(scale), int(seed) & _U32,
            dropout_threshold(rate), dfa_nk_p(nk), 1.0 / (1.0 - rate),
            *mask_offsets(offsets, h), _DTYPE_CODE[q.dtype],
            _ROUTE_CODE[attention_route(q.dtype, dqk, dv)],
            _stream(q.device))
    del keep_alive
    _raise_on(lib, "flash_attention_fwd", err)
    return o


def attention_train_forward(q, k, v, scale, bias=None, seed=0, rate=0.0,
                            offsets=None):
    """The train forward, (o, lse (B*H, Nq) f32): the plain version on a CPU
    tensor, the flash kernel (csrc/flash_attention_fwd.cu with lse and, at
    rate > 0, dropout) on a CUDA tensor. `offsets` (b_off, h_off, h_total,
    q_off) place q's batch rows, heads and query rows in the whole batch
    for the mask (`mask_offsets`)."""
    if q.device.type == "cpu":
        return attention_train_reference(q, k, v, scale, bias, seed, rate,
                                         offsets=offsets)
    _cuda_only(q)
    _check(q, k, v, bias)
    b, h, nq, _ = q.shape
    lse = torch.empty((b * h, nq), dtype=torch.float32, device=q.device)
    o = _flash_forward(q, k, v, scale, bias, lse, seed, rate, offsets)
    attention_train_forward.launches += 1
    return o, lse


attention_train_forward.launches = 0


def attention_backward(q, k, v, o, lse, g, scale, bias=None, seed=0,
                       rate=0.0, offsets=None):
    """(dq, dk, dv) of the train forward: the plain version on a CPU tensor,
    the flash backward kernels (csrc/flash_attention_bwd.cu: D = rowsum(g *
    o), which `_dfa_bwd` takes outside its Pallas kernel, then dk and dv,
    then dq) on a CUDA tensor; `offsets` as the forward's."""
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, o, lse, g, scale, bias,
                                            seed, rate, offsets=offsets)
    _cuda_only(q)
    b, h, nq, dqk = q.shape
    nk, dv = k.shape[2], v.shape[3]
    if tuple(g.shape) != (b, h, nq, dv) or tuple(o.shape) != (b, h, nq, dv):
        raise ValueError(f"g and o must be ({b}, {h}, {nq}, {dv}), got "
                         f"{tuple(g.shape)} and {tuple(o.shape)}")
    if tuple(lse.shape) != (b * h, nq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 ({b * h}, {nq}), got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if g.dtype != q.dtype or o.dtype != q.dtype:
        raise TypeError(f"g and o must be {q.dtype}, got {g.dtype} and "
                        f"{o.dtype}")
    _check(q, k, v, bias, extra=(("g", g), ("o", o), ("lse", lse)))
    dsum = torch.empty((b * h, nq), dtype=torch.float32, device=q.device)
    route = attention_route(q.dtype, dqk, dv)
    dq = torch.empty_like(q)
    # the wgmma kernel sums dq in f32 across its key blocks
    dq_f32 = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
              if route == "wgmma" else None)
    dk = torch.empty_like(k)
    dvv = torch.empty_like(v)
    keep_alive, bias_ptr, bias_max_ptr = _bias_args(bias)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            g.data_ptr(), lse.data_ptr(), dsum.data_ptr(), bias_ptr,
            bias_max_ptr,
            dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
            None if dq_f32 is None else dq_f32.data_ptr(), b, h, nq, nk, dqk,
            dv, float(scale), int(seed) & _U32, dropout_threshold(rate),
            dfa_nk_p(nk), 1.0 / (1.0 - rate), *mask_offsets(offsets, h),
            _DTYPE_CODE[q.dtype],
            _ROUTE_CODE[route], _stream(q.device))
    del keep_alive
    _raise_on(lib, "flash_attention_bwd", err)
    attention_backward.launches += 1
    return dq, dk, dvv


attention_backward.launches = 0


def dropout_keep_mask(n_bh: int, nq: int, nk: int, seed: int, rate: float,
                      device, nk_p: int | None = None,
                      q_off: int = 0) -> torch.Tensor:
    """The keep mask as (n_bh, Nq, Nk) uint8 0/1 on `device`, of the query
    rows q_off..q_off+Nq-1: the plain hash on the CPU, the probe kernel
    (csrc/dropout_keep_mask.cu, the device function the attention kernels
    share) on a GPU."""
    device = torch.device(device)
    nk_p = dfa_nk_p(nk) if nk_p is None else nk_p
    thr = dropout_threshold(rate)
    if device.type == "cpu":
        return dropout_keep(seed, n_bh, nq, nk, nk_p, thr,
                            row0=q_off).to(torch.uint8)
    if device.type != "cuda":
        raise ValueError(f"no mask kernel for device {device}")
    if min(n_bh, nq, nk) < 1 or n_bh * nq * nk >= 2**62:
        raise ValueError(f"bad mask shape ({n_bh}, {nq}, {nk})")
    if n_bh >= 2**31 or nq >= 2**31 or nk >= 2**31:
        raise ValueError("each mask dimension must fit a 32-bit int")
    if not 0 <= q_off < 2**32:
        raise ValueError(f"q_off {q_off} must fit a 32-bit unsigned int")
    if nq * -(-nk // 16) >= 2**31:
        raise ValueError(f"Nq * ceil(Nk / 16) must be below 2**31, got "
                         f"({nq}, {nk})")
    out = torch.empty((n_bh, nq, nk), dtype=torch.uint8, device=device)
    lib = _mask_library()
    with torch.cuda.device(device):
        err = lib.dropout_keep_mask(out.data_ptr(), n_bh, nq, nk,
                                    int(seed) & _U32, thr, nk_p & _U32,
                                    q_off, _stream(device))
    _raise_on(lib, "dropout_keep_mask", err)
    dropout_keep_mask.launches += 1
    return out


dropout_keep_mask.launches = 0


def packed2_attention(q, k, v, scale=None):
    """softmax(q k^T * scale) v with two heads per block, a probe (the JAX
    package's `packed2_fwd`): bf16, head width 64, an even number of heads,
    no bias, no dropout, no gradient. A CPU tensor takes the plain version
    (`attention_reference`); a CUDA tensor launches the kernel (the
    two-head instance of the wgmma forward, csrc/packed2_attention_fwd.cu)
    or raises."""
    if (q.dim() != 4 or v.dim() != 4 or q.shape[1] % 2 or q.shape[3] != 64
            or v.shape[3] != 64):
        raise ValueError("the packed probe takes head width 64 and an even "
                         f"number of heads, got q {tuple(q.shape)}, "
                         f"v {tuple(v.shape)}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    _cuda_only(q)
    _check(q, k, v, None)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the packed kernel takes bfloat16, got {q.dtype}")
    b, h, nq, _ = q.shape
    o = torch.empty_like(q)
    lib = _packed2_library()
    with torch.cuda.device(q.device):
        err = lib.packed2_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h,
            nq, k.shape[2], float(scale), _stream(q.device))
    _raise_on(lib, "packed2_attention_fwd", err)
    packed2_attention.launches += 1
    return o


packed2_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """Train forward and backward kernels under autograd (the plain versions
    on CPU tensors). The bias gets no gradient, as `_masked_bwd` gives it a
    zero one. `offsets` (b_off, h_off, h_total[, q_off]), or None, place
    the call's rows, heads and query rows in the whole batch for the
    dropout mask (`mask_offsets`)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate, scale, offsets):
        o, lse = attention_train_forward(q, k, v, scale, bias, seed, rate,
                                         offsets)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.seed, ctx.rate, ctx.scale = seed, rate, scale
        ctx.offsets = offsets
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o, lse, g.contiguous(),
                                        ctx.scale, bias, ctx.seed, ctx.rate,
                                        ctx.offsets)
        return dq, dk, dv, None, None, None, None, None


def dropout_flash_attention(q, k, v, seed: int, scale: float, rate: float,
                            offsets=None):
    """Train-mode attention with dropout on the probabilities (the JAX
    package's `dropout_flash_attention`): differentiable; the same seed
    regenerates the same mask. Rate 0 runs no hash. `offsets` as
    FlashAttention's."""
    return FlashAttention.apply(q, k, v, None, seed, rate, scale, offsets)


def fused_attention(q, k, v, scale=None, key_padding_mask=None):
    """softmax(q k^T * scale, masked) v, (B,H,N,D) in and out.

    `scale` defaults to Dqk ** -0.5. With autograd recording on q, k or v it
    is the differentiable FlashAttention at rate 0. Otherwise a CPU tensor
    takes the plain version and a CUDA tensor launches the eval kernel on
    the current stream, without synchronising, or raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bias = None if key_padding_mask is None else padding_bias(key_padding_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, bias, 0, 0.0, scale, None)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, bias)
    _cuda_only(q)
    _check(q, k, v, bias)
    o = _flash_forward(q, k, v, scale, bias, None, 0, 0.0)
    fused_attention.launches += 1
    return o


fused_attention.launches = 0
