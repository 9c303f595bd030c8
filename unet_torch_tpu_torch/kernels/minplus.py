"""Min-plus (tropical) matrix product: the Hopper kernel and its plain PyTorch
version.

    C[i, j] = min_k A[i, k] + B[k, j]

The JAX package's Pallas kernel (unet_torch_tpu/kernels/minplus.py) is ported
as a hand-written CUDA kernel, csrc/minplus.cu. Two such products against the
squared-distance tables make the exact squared Euclidean distance transform
that the Hausdorff-DT loss needs (losses/functional.py).

The TPU kernel takes one 2-D product and is `vmap`ped over images. Here one
launch takes a batch: `a` is (M, K) or (Bt, M, K), `b` is (K, N) or
(Bt, K, N), f32; a 2-D operand beside a 3-D one is shared by the whole batch
(a batch stride of 0, nothing is copied). The result is (M, N) for two 2-D
operands, else (Bt, M, N).

`minplus` routes by the device of `a`: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, which raises on anything it does not
take. `minplus.launches` counts the kernel's launches. The product has no
gradient (the distance fields are constants of the loss), so the kernel
refuses tensors that autograd is recording.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from unet_torch_tpu_torch.kernels import build

_KERNEL = "minplus"


def _batched(a, b):
    """(a3, b3, batched): both as 3-D views, a 2-D operand expanded with a
    batch stride of 0."""
    if a.dim() not in (2, 3) or b.dim() not in (2, 3):
        raise ValueError(f"a and b must be 2-D or 3-D, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    batched = a.dim() == 3 or b.dim() == 3
    bt = a.shape[0] if a.dim() == 3 else b.shape[0] if b.dim() == 3 else 1
    a3 = a if a.dim() == 3 else a.unsqueeze(0).expand(bt, -1, -1)
    b3 = b if b.dim() == 3 else b.unsqueeze(0).expand(bt, -1, -1)
    if a3.shape[0] != b3.shape[0] or a3.shape[2] != b3.shape[1]:
        raise ValueError(f"cannot multiply {tuple(a.shape)} by "
                         f"{tuple(b.shape)}")
    if min(*a3.shape, b3.shape[2]) == 0:
        raise ValueError(f"empty operand: {tuple(a.shape)}, {tuple(b.shape)}")
    return a3, b3, batched


def minplus_reference(a, b):
    """Plain version: broadcast add, then the minimum over k, one batch
    element at a time (each materialises an (M, K, N) intermediate)."""
    a3, b3, batched = _batched(a.float(), b.float())
    out = torch.stack([
        torch.amin(a3[z][:, :, None] + b3[z][None, :, :], dim=1)
        for z in range(a3.shape[0])])
    return out if batched else out[0]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    lib.minplus.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    lib.minplus.restype = ctypes.c_int
    lib.minplus_error_string.argtypes = [ctypes.c_int]
    lib.minplus_error_string.restype = ctypes.c_char_p
    return lib


def _check(a3, b3):
    for name, t in (("a", a3), ("b", b3)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != a3.device:
            raise ValueError(f"{name} is on {t.device}, a on {a3.device}")
        if t.stride(2) != 1 or t.stride(1) != t.shape[2]:
            raise ValueError(f"the last two dimensions of {name} must be "
                             f"contiguous, got strides {t.stride()}")
        if t.shape[0] > 1 and t.stride(0) not in (0, t.shape[1] * t.shape[2]):
            raise ValueError(f"the batch stride of {name} must be 0 or "
                             f"M*K, got strides {t.stride()}")
        if t.shape[0] > 65535 or t.shape[1] > 65535 * 128:
            raise ValueError(f"{name} {tuple(t.shape)} exceeds the kernel's "
                             "grid")
    if torch.is_grad_enabled() and (a3.requires_grad or b3.requires_grad):
        raise RuntimeError("the min-plus kernel has no gradient; call it "
                           "under torch.no_grad() or on detached tensors")


def minplus(a, b):
    """min_k a[.., i, k] + b[.., k, j], f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the Hopper
    kernel on the current stream, without synchronising, or raises."""
    if a.device.type == "cpu":
        return minplus_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no min-plus product for device {a.device}")
    a3, b3, batched = _batched(a, b)
    _check(a3, b3)
    bt, m, k = a3.shape
    n = b3.shape[2]
    c = torch.empty((bt, m, n), dtype=torch.float32, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.minplus(a3.data_ptr(), b3.data_ptr(), c.data_ptr(), bt, m,
                          k, n, a3.stride(0) if bt > 1 else 0,
                          b3.stride(0) if bt > 1 else 0, stream)
    if err:
        msg = lib.minplus_error_string(err).decode()
        raise RuntimeError(f"minplus launch failed: {msg}")
    minplus.launches += 1
    return c if batched else c[0]


minplus.launches = 0
