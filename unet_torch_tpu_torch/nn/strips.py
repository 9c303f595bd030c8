"""The layers that read across the rows of an image, on a strip of it
(parallel/spatial.py): each returns the strip's rows of what the layer
computes on the whole image, from the strip and what the ranks of the
strip group (`group`, core/mesh.py `model_group` under the "spatial" role)
exchange. A group of None is the whole image in one strip, where each is
the plain layer.

  strip_conv2d       a k x k conv with stride s and row padding p reads p
                     rows above the strip and k - 1 - p below it
                     (core/dist.py::exchange_rows); the strip owns the
                     output rows whose window's row p (its centre, for a
                     padded conv) it holds, ceil(rows / s) of them where it
                     starts at a multiple of s
  strip_group_norm   each image's (group, H, W) statistics summed over the
                     strips: the mean first, then the centred sum of
                     squares (one pass cancels in f32, nn/sync_batchnorm.py),
                     the counts of uneven strips included
  upsample_rows_2x   the align-corners bilinear 2x upsample: an output row
                     reads the two input rows around (H - 1) / (2H - 1)
                     times its global index, so a strip's first output
                     row reads the last row of the strip above it and its
                     last the first row of the strip below

Each is differentiable: every rank differentiates its own share of the
loss, and the collectives' backwards hand each rank the sum of the ranks'
gradients of what it sent.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from unet_torch_tpu_torch.core.dist import all_reduce_sum, exchange_rows


def strip_conv2d(x, weight, bias, stride, padding, group):
    """F.conv2d(x, weight, bias, stride, padding) of the whole image at
    the NCHW strip `x` (module docstring)."""
    if group is None:
        return F.conv2d(x, weight, bias, stride, padding)
    ph, pw = _pair(padding)
    kh = weight.shape[2]
    if kh > 1 or ph:
        x = exchange_rows(x, group, above=ph, below=kh - 1 - ph)
    return F.conv2d(x, weight, bias, stride, (0, pw))


def strip_group_norm(x, num_groups: int, weight, bias, eps: float, group):
    """F.group_norm of the whole image at the NCHW strip `x`, statistics in
    f32 (f64 for an f64 input), the affine in x's dtype as F.group_norm
    takes it; the result in x's dtype and memory format."""
    b, c, h, w = x.shape
    ctype = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ctype).reshape(b, num_groups, -1)
    count = torch.full((1,), xf.shape[-1], dtype=ctype, device=x.device)
    stats = all_reduce_sum(torch.cat([xf.sum(-1).reshape(-1), count]), group)
    n = stats[-1]
    centred = xf - (stats[:-1] / n).view(b, num_groups, 1)
    var = all_reduce_sum((centred * centred).sum(-1), group) / n
    y = (centred * torch.rsqrt(var + eps)[..., None]).view(b, c, h, w)
    shape = (1, c, 1, 1)
    y = (y * weight.to(x.dtype).to(ctype).view(shape)
         + bias.to(x.dtype).to(ctype).view(shape))
    fmt = (torch.channels_last if x.is_contiguous(
        memory_format=torch.channels_last) and not x.is_contiguous()
        else torch.contiguous_format)
    return y.to(x.dtype).contiguous(memory_format=fmt)


def _align_corners_rows(n_in: int, n_out: int, device=None, dtype=None):
    """(lo, hi, frac) of each of `n_out` output rows of an align-corners
    linear resize from `n_in`: it reads rows lo and hi with weights 1 -
    frac and frac, computed as torch's upsample kernels compute them
    (scale = (n_in - 1) / (n_out - 1) in the compute dtype, times the
    index)."""
    dtype = dtype or torch.float32
    scale = (torch.tensor(n_in - 1, dtype=dtype)
             / (n_out - 1) if n_out > 1 else torch.tensor(0, dtype=dtype))
    pos = scale.to(device) * torch.arange(n_out, dtype=dtype, device=device)
    lo = pos.floor().long()
    return lo, (lo + 1).clamp(max=n_in - 1), pos - lo


def upsample_rows_2x(x, group, m: int, strips: int):
    """NHWC strip m of `strips` (equal ones) -> its rows of the whole
    image's align-corners bilinear 2x upsample, in x's dtype: the width by
    F.interpolate and the height from the global rows, both in f32 (f64
    for an f64 input) and rounded once, as the one-process kernel rounds."""
    b, h, w, c = x.shape
    ctype = torch.promote_types(x.dtype, torch.float32)
    # row 0: the last row of the strip above, row h + 1 the first of the
    # strip below (zeros past the image, where their weight is 0)
    xs = exchange_rows(x, group, dim=1).to(ctype)
    y = F.interpolate(xs.permute(0, 3, 1, 2), size=(h + 2, 2 * w),
                      mode="bilinear", align_corners=True).permute(0, 2, 3, 1)
    lo, hi, frac = _align_corners_rows(h * strips, 2 * h * strips,
                                       x.device, ctype)
    rows = slice(2 * h * m, 2 * h * (m + 1))
    first = m * h - 1  # the global row of xs's row 0
    frac = frac[rows].view(1, -1, 1, 1)
    y = y[:, lo[rows] - first] * (1 - frac) + y[:, hi[rows] - first] * frac
    return y.to(x.dtype)
