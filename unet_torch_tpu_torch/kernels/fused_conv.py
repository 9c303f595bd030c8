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
not take. The source holds four mainloops; `conv_route` picks one from the
dtype and the channel counts alone ("wgmma", "narrow", "mma.sync" or "reg"),
and `conv_tile_plan` lays out the wgmma route's tiles (the narrow route plans
its own). There is no fallback: a
route that fails to build or launch raises.
`fused_conv3x3_bn_relu.launches` counts the kernel's launches and
`.launches_by_route` the same launches by route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from unet_torch_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# which mainloop of the source a call launches, as its C entry point numbers
# them
_ROUTE_CODE = {"reg": 0, "mma.sync": 1, "wgmma": 2, "narrow": 3}
ROUTES = tuple(_ROUTE_CODE)
_KERNEL = "fused_conv3x3_bn_relu"
# output pixels of a wgmma tile: two consumer warpgroups of 64 rows
TILE_PIXELS = 128
# the narrow route's widest input and output: a halo pixel of at most 16
# channels (32 bytes), output channels in passes of 16, 32 or 64
NARROW_MAX_CIN = 16
NARROW_MAX_COUT = 256


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


def conv_route(dtype: torch.dtype, cin: int, cout: int) -> str:
    """Which mainloop of csrc/fused_conv3x3_bn_relu.cu a call launches, a
    function of the dtype and the channel counts alone: "reg" for float32
    (full f32 on the CUDA cores); for bfloat16 "wgmma" where Cin is a
    multiple of 64 and Cout of 16 (the TMA boxes' 64 channels; the weight's
    rows a multiple of 32 bytes), "narrow" where Cin is at most 16 and Cout
    a multiple of 16 up to 256 (the UNet family's first conv, the TransUnet
    decoder's last: a staged halo of image rows, TMA stores),
    "mma.sync" where both are multiples of 8 (16-byte cp.async gathers),
    "reg" otherwise (ragged channel counts)."""
    if dtype == torch.float32:
        return "reg"
    if dtype != torch.bfloat16:
        raise TypeError(f"no fused conv kernel for {dtype}")
    if cin % 64 == 0 and cout % 16 == 0:
        return "wgmma"
    if cin <= NARROW_MAX_CIN and cout % 16 == 0 and cout <= NARROW_MAX_COUT:
        return "narrow"
    if cin % 8 == 0 and cout % 8 == 0:
        return "mma.sync"
    return "reg"


class TilePlan(NamedTuple):
    """The wgmma route's tiles: ht x wt output pixels of one image by bn
    output channels; tiles_h * tiles_w pixel tiles an image, n_tiles channel
    tiles each; `tiles` in all. `halo`: the kernel stages the (ht + 2) x
    (wt + 2) pixels around a tile once per 64 input channels, instead of a
    box of the tile's pixels for each of the nine taps."""
    ht: int
    wt: int
    bn: int
    tiles_h: int
    tiles_w: int
    n_tiles: int
    tiles: int
    halo: bool


def conv_tile_plan(b: int, h: int, w: int, cout: int) -> TilePlan:
    """The wgmma route's tile plan: wt the least power of two >= W, at most
    64 (at W = 32, 4 x 32; at W >= 64, 2 x 64); bn = 64, 128 or 256, the
    least that covers Cout (at most 256), so that each pixel tile's image
    rows are read from L2 as few times as the tiles allow. The halo is
    staged where a consumer warpgroup's 64 rows are one image row (wt = 64)
    and its stages fit beside the weight's (bn <= 128): the UNet's 512x512
    and 256x256 levels and the TransUnet decoder's from 128x128 up, where
    the per-tap boxes read each x value from L2 nine times."""
    wt = min(64, 1 << max(0, (w - 1).bit_length()))
    ht = TILE_PIXELS // wt
    bn = 64 if cout <= 64 else 128 if cout <= 128 else 256
    tiles_h, tiles_w, n_tiles = -(-h // ht), -(-w // wt), -(-cout // bn)
    return TilePlan(ht, wt, bn, tiles_h, tiles_w, n_tiles,
                    b * tiles_h * tiles_w * n_tiles, wt == 64 and bn <= 128)


def conv_tile_origin(plan: TilePlan, t: int) -> tuple[int, int, int, int]:
    """(b, h0, w0, n0) of tile t, output channels innermost, as the kernel's
    `tile_origin` reads it."""
    q, nt = divmod(t, plan.n_tiles)
    q, tw = divmod(q, plan.tiles_w)
    b, th = divmod(q, plan.tiles_h)
    return b, th * plan.ht, tw * plan.wt, nt * plan.bn


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    lib.fused_conv3x3_bn_relu.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
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
    kernel's `conv_route` mainloop on the current stream, without
    synchronising, or raises."""
    if x.device.type == "cpu":
        return fused_conv3x3_bn_relu_reference(x, w, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no fused conv for device {x.device}")
    _check(x, w, scale, bias)
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    route = conv_route(x.dtype, cin, cout)
    wt = bn = halo = 0
    if route == "wgmma":
        plan = conv_tile_plan(b, h, wd, cout)
        wt, bn, halo = plan.wt, plan.bn, int(plan.halo)
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_conv3x3_bn_relu(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), b, h, wd, cin, cout, _DTYPE_CODE[x.dtype],
            _ROUTE_CODE[route], wt, bn, halo, stream)
    if err:
        msg = lib.fused_conv3x3_bn_relu_error_string(err).decode()
        raise RuntimeError(f"fused_conv3x3_bn_relu launch failed on the "
                           f"{route} route: {msg}")
    fused_conv3x3_bn_relu.launches += 1
    fused_conv3x3_bn_relu.launches_by_route[route] += 1
    return y


def reset_launches() -> None:
    """Sets `fused_conv3x3_bn_relu.launches` and every route's count to 0."""
    fused_conv3x3_bn_relu.launches = 0
    fused_conv3x3_bn_relu.launches_by_route = dict.fromkeys(ROUTES, 0)


reset_launches()
