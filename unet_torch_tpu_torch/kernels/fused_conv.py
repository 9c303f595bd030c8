"""Fused conv3x3 + BatchNorm (folded) + ReLU: the Hopper kernel and its plain
PyTorch version.

The JAX package's Pallas kernel (unet_torch_tpu/kernels/fused_conv.py) is
ported as a hand-written CUDA kernel, csrc/fused_conv3x3_bn_relu.cu. This is
the inference half of DoubleConv: BN with running statistics folds into a
per-channel scale and bias,

    scale = gamma / sqrt(var + eps);  bias = beta - mean * scale,

and the kernel computes max(conv3x3_same(x, w) * scale + bias, 0) in one pass.

Layouts follow the JAX package: x is NHWC, w is HWIO, scale and bias are f32
vectors of length Cout; the result is NHWC in x's dtype.

`fused_conv3x3_bn_relu` routes by the device of x: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel, which raises on anything it does
not take. `fused_conv3x3_bn_relu.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from unet_torch_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL = "fused_conv3x3_bn_relu"


def fold_bn(gamma, beta, mean, var, eps=1e-5):
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale


def fused_conv3x3_bn_relu_reference(x, w, scale, bias):
    """x (B,H,W,Cin), w (3,3,Cin,Cout), scale/bias (Cout,) f32.

    The conv runs in x's dtype; the affine and ReLU run in f32 and the
    result is rounded to x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = torch.relu(y.permute(0, 2, 3, 1).float() * scale + bias)
    return y.to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    lib.fused_conv3x3_bn_relu.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.fused_conv3x3_bn_relu.restype = ctypes.c_int
    lib.fused_conv3x3_bn_relu_error_string.argtypes = [ctypes.c_int]
    lib.fused_conv3x3_bn_relu_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w, scale, bias):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC (4-D), got shape {tuple(x.shape)}")
    b, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    cout = w.shape[3]
    if tuple(scale.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError(f"scale and bias must be ({cout},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    if min(b, h, wd, cin, cout) == 0:
        raise ValueError(f"empty input: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if b * h * wd >= 2**31:
        raise ValueError(f"B*H*W = {b * h * wd} does not fit the kernel's "
                         "32-bit pixel index")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("scale and bias must be float32")
    for name, t in (("w", w), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (x in NHWC order)")
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, scale, bias)):
        raise RuntimeError("the fused conv kernel is inference-only; call it "
                           "under torch.no_grad() or torch.inference_mode()")


def fused_conv3x3_bn_relu(x, w, scale, bias):
    """max(conv3x3_same(x, w) * scale + bias, 0), NHWC in and out.

    A CPU tensor takes the plain version; a CUDA tensor launches the Hopper
    kernel on the current stream, without synchronising, or raises."""
    if x.device.type == "cpu":
        return fused_conv3x3_bn_relu_reference(x, w, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no fused conv for device {x.device}")
    _check(x, w, scale, bias)
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_conv3x3_bn_relu(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), b, h, wd, cin, cout, _DTYPE_CODE[x.dtype], stream)
    if err:
        msg = lib.fused_conv3x3_bn_relu_error_string(err).decode()
        raise RuntimeError(f"fused_conv3x3_bn_relu launch failed: {msg}")
    fused_conv3x3_bn_relu.launches += 1
    return y


fused_conv3x3_bn_relu.launches = 0
