"""Attention forward: the Hopper flash kernel and its plain PyTorch version.

The JAX package's two Pallas kernels (unet_torch_tpu/kernels/attention.py:
`_attention_pallas`, the whole sequence per batch*head, and `_attention_flash`,
an online softmax over key tiles) compute the same function and differ only
in how much of it the TPU's VMEM holds. Both are ported as one hand-written
CUDA kernel, csrc/flash_attention_fwd.cu:

    o = softmax(q @ k^T * scale + bias) @ v

Layouts follow the JAX package: q and k are (B, H, N, Dqk), v is
(B, H, Nk, Dv), the result (B, H, Nq, Dv) in q's dtype. Dqk may differ from
Dv (CLTR's cross-attention). A key-padding mask (B, Nk), True on padding,
becomes an additive (B, Nk) f32 bias of -1e30, as `_attention_pallas` takes
it; a batch row whose keys are all padding then gets the mean of its Nk rows
of v in both versions here. (The JAX package's einsum fallback gives NaN for
such a row, and `_attention_flash` averages over its zero-padded columns
too.)

`fused_attention` routes by the device of q: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, which raises on anything it does not
take. `fused_attention.launches` counts the kernel's launches. Forward only:
the kernel raises when autograd records on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from unet_torch_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL = "flash_attention_fwd"
# -1e30 marks padding keys, as in the JAX package
PAD_BIAS = -1e30


def padding_bias(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """(B, Nk) bool, True on padding -> (B, Nk) f32 additive score bias."""
    zeros = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                        device=key_padding_mask.device)
    return zeros.masked_fill(key_padding_mask, PAD_BIAS)


def attention_reference(q, k, v, scale, bias=None):
    """q, k (B,H,Nq/Nk,Dqk), v (B,H,Nk,Dv), bias (B,Nk) f32 or None.

    Mirrors the Pallas kernels: f32 scores from q's dtype, f32 softmax, the
    probabilities rounded to v's dtype, the second product summed in f32 and
    rounded once to q's dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float())
    return o.to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_fwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, bias):
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
    if b * h * nq >= 2**31:
        raise ValueError(f"B*H*Nq = {b * h * nq} does not fit the kernel's "
                         "32-bit block index")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    tensors = [("q", q), ("k", k), ("v", v)]
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
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in tensors):
        raise RuntimeError("the attention kernel is forward-only; call it "
                           "under torch.no_grad() or torch.inference_mode()")


def fused_attention(q, k, v, scale=None, key_padding_mask=None):
    """softmax(q k^T * scale, masked) v, (B,H,N,D) in and out.

    `scale` defaults to Dqk ** -0.5. A CPU tensor takes the plain version; a
    CUDA tensor launches the Hopper kernel on the current stream, without
    synchronising, or raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bias = None if key_padding_mask is None else padding_bias(key_padding_mask)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, bias)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v, bias)
    b, h, nq, dqk = q.shape
    nk, dv = k.shape[2], v.shape[3]
    o = torch.empty((b, h, nq, dv), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), o.data_ptr(),
            b, h, nq, nk, dqk, dv, float(scale), _DTYPE_CODE[q.dtype], stream)
    if err:
        msg = lib.flash_attention_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg}")
    fused_attention.launches += 1
    return o


fused_attention.launches = 0
