"""The Hopper kernels (fused conv3x3+BN+ReLU on its wgmma, narrow, mma.sync
and register routes, flash attention forward in
its eval and train calls and flash attention backward on their wgmma,
mma.sync and f32 routes, dropout keep-mask probe, min-plus product, auction,
packed attention probe) against their plain PyTorch versions, on a CUDA card;
and the topo losses' host pairing of a likelihood made on the card. Skips
without one: the kernels have no CPU mode.

This file imports no JAX, so that it runs where only the port is installed:

    python -m pytest tests/test_torch_port_kernel_cuda.py -m cuda --noconftest
"""

import copy

import numpy as np
import pytest
import torch

from unet_torch_tpu_torch.kernels import attention as port_attn
from unet_torch_tpu_torch.kernels import fused_conv as port_fc
from unet_torch_tpu_torch.kernels import minplus as port_mp

# (B, H, W, Cin, Cout): tests/test_fused_conv.py's shapes (odd H in the
# second), the ragged Cin=3 of the UNet's first conv with an odd W, odd H and
# W with Cin=64, and a K and a Cout that end inside a tile (Cin=24: 216 taps;
# Cout=136: two 128-wide N tiles). The bf16 shapes with Cin and Cout
# multiples of 8 take the pipelined mma.sync mainloop, the others and f32 the
# register one (`conv_route`); the wgmma route's shapes follow below.
SHAPES = [(2, 16, 32, 8, 8), (1, 13, 16, 4, 8), (1, 9, 7, 3, 8),
          (2, 33, 17, 64, 8), (1, 9, 20, 24, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    *xshape, cin, cout = shape
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*xshape, cin).astype(np.float32))
    k = torch.from_numpy(
        (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32))
    gamma, var = (torch.from_numpy((rng.rand(cout) + 0.5).astype(np.float32))
                  for _ in range(2))
    beta, mean = (torch.from_numpy(rng.randn(cout).astype(np.float32))
                  for _ in range(2))
    scale, bias = port_fc.fold_bn(gamma.cuda(), beta.cuda(), mean.cuda(),
                                  var.cuda())
    xd, kd = x.cuda().to(dtype), k.cuda().to(dtype)
    route = port_fc.conv_route(dtype, cin, cout)
    before = port_fc.fused_conv3x3_bn_relu.launches
    before_route = port_fc.fused_conv3x3_bn_relu.launches_by_route[route]
    with torch.inference_mode():
        out = port_fc.fused_conv3x3_bn_relu(xd, kd, scale, bias)
        torch.cuda.synchronize()
        ref = port_fc.fused_conv3x3_bn_relu_reference(xd, kd, scale, bias)
    assert port_fc.fused_conv3x3_bn_relu.launches == before + 1
    assert (port_fc.fused_conv3x3_bn_relu.launches_by_route[route]
            == before_route + 1)
    assert out.shape == ref.shape and out.dtype == dtype
    err = (out.float() - ref.float()).abs().max().item()
    peak = ref.float().abs().max().item()
    # f32: sums of 9*Cin products in another order. bf16: the plain version
    # rounds the conv output to bf16 before the affine and again after, the
    # kernel once, so they may differ by up to two bf16 ulps (2**-7 each).
    bound = 1e-4 * peak if dtype == torch.float32 else 2 ** -6 * peak
    assert err <= bound, (err, bound)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    x = torch.randn(1, 8, 8, 16, device="cuda")
    w = torch.randn(3, 3, 16, 8, device="cuda")
    s = torch.ones(8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        port_fc.fused_conv3x3_bn_relu(x.permute(0, 2, 1, 3), w, s, s)
    with pytest.raises(TypeError):
        port_fc.fused_conv3x3_bn_relu(x.half(), w.half(), s, s)
    with pytest.raises(ValueError, match="w must be"):
        port_fc.fused_conv3x3_bn_relu(x, w[:2], s, s)
    with pytest.raises(RuntimeError, match="inference-only"):
        port_fc.fused_conv3x3_bn_relu(x, w.requires_grad_(), s, s)


def _conv_inputs(shape, seed=0):
    """x, w, scale, bias on the card in bf16 (scale and bias f32), the
    weight kaiming-scaled so that outputs stay O(1)."""
    *xshape, cin, cout = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(*xshape, cin).astype(np.float32)
    w = (rng.randn(3, 3, cin, cout) * (2.0 / (9 * cin)) ** 0.5).astype(
        np.float32)
    gamma, var = ((rng.rand(cout) + 0.5).astype(np.float32) for _ in range(2))
    beta, mean = ((rng.randn(cout) * 0.1).astype(np.float32)
                  for _ in range(2))
    scale, bias = port_fc.fold_bn(*(torch.from_numpy(a).cuda()
                                    for a in (gamma, beta, mean, var)))
    return (torch.from_numpy(x).cuda().to(torch.bfloat16),
            torch.from_numpy(w).cuda().to(torch.bfloat16), scale, bias)


def _conv_on_route(monkeypatch, route, args):
    """The kernel's output with every call sent down `route` ("wgmma per
    tap": the wgmma route without the staged halo tile), and the launches
    that went down it."""
    if route == "wgmma per tap":
        plan = port_fc.conv_tile_plan
        monkeypatch.setattr(port_fc, "conv_tile_plan",
                            lambda *a: plan(*a)._replace(halo=False))
        route = "wgmma"
    if route != port_fc.conv_route(args[0].dtype, args[0].shape[-1],
                                   args[1].shape[-1]):
        monkeypatch.setattr(port_fc, "conv_route", lambda *_: route)
    before = port_fc.fused_conv3x3_bn_relu.launches_by_route[route]
    with torch.inference_mode():
        out = port_fc.fused_conv3x3_bn_relu(*args)
        torch.cuda.synchronize()
    return out, port_fc.fused_conv3x3_bn_relu.launches_by_route[route] - before


# (B, H, W, Cin, Cout) of the wgmma route: every pair of Cin 64, 128, 192
# and Cout 16, 64, 128, 320 (16 ends inside a 64-wide channel tile, 320
# inside its second 256-wide one) at odd H and two odd W: 19 (under the
# widest pixel tile, and not a multiple of its 32) and 69 (2 x 64 tiles, the
# staged halo up to Cout 128, the second tile past the edge); the shapes
# below: W 17 < 64, W 70 past one 64-wide tile with H 7 (the last tile's
# lower taps lie wholly outside the image), three images at W 32, and a
# 512x512 main-path shape.
WGMMA_CONV_SHAPES = ([(2, 11, w, cin, cout) for w in (19, 69)
                      for cin in (64, 128, 192)
                      for cout in (16, 64, 128, 320)]
                     + [(2, 33, 17, 64, 64), (1, 7, 70, 128, 192),
                        (1, 7, 70, 128, 64), (3, 32, 32, 192, 64),
                        (1, 512, 512, 64, 64)])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "wgmma per tap", "mma.sync"])
@pytest.mark.parametrize("shape", WGMMA_CONV_SHAPES)
def test_wgmma_route_matches_plain_on_card(monkeypatch, shape, route):
    """bf16 within two ulps of the output's peak, as the other routes; the
    wgmma kernel without its halo tile and the mma.sync kernel held at the
    same shapes, through overrides of the plan and the route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    assert port_fc.conv_route(torch.bfloat16, *shape[3:]) == "wgmma"
    args = _conv_inputs(shape)
    out, launched = _conv_on_route(monkeypatch, route, args)
    with torch.inference_mode():
        ref = port_fc.fused_conv3x3_bn_relu_reference(*args)
    assert launched == 1
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs().max().item()
    bound = 2 ** -6 * ref.float().abs().max().item()
    assert err <= bound, (err, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "wgmma per tap"])
@pytest.mark.parametrize("cout", [16, 320])
def test_wgmma_route_reads_no_halo_across_images_on_card(monkeypatch, cout,
                                                         route):
    """Images 0 and 2 are zeros, image 1 is 100x larger than the rest: a tap
    that read across an image boundary would move images 0 and 2 off
    relu(bias), which they must equal exactly (W 70: 2 x 64 tiles, with the
    staged halo at Cout 16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    x, w, scale, bias = _conv_inputs((3, 9, 70, 64, cout), seed=2)
    x[0] = 0
    x[2] = 0
    x[1] *= 100
    out, launched = _conv_on_route(monkeypatch, route, (x, w, scale, bias))
    assert launched == 1
    with torch.inference_mode():
        ref = port_fc.fused_conv3x3_bn_relu_reference(x, w, scale, bias)
    floor = torch.relu(bias).to(torch.bfloat16).expand(9, 70, cout)
    assert torch.equal(out[0], floor) and torch.equal(out[2], floor)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -6 * ref.float().abs().max().item()


@pytest.mark.cuda
def test_conv_routes_refuse_what_they_cannot_serve_on_card(monkeypatch):
    """A route the call cannot take raises, and nothing else is launched in
    its place: wgmma at Cin 24, mma.sync at Cout 12, either in f32; narrow
    in f32, at Cin 24, at Cout 24 (not a multiple of 16) and at Cout 272."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    for route, shape, dtype in (("wgmma", (1, 8, 8, 24, 64), torch.bfloat16),
                                ("mma.sync", (1, 8, 8, 64, 12),
                                 torch.bfloat16),
                                ("wgmma", (1, 8, 8, 64, 64), torch.float32),
                                ("narrow", (1, 8, 8, 3, 64), torch.float32),
                                ("narrow", (1, 8, 8, 24, 64), torch.bfloat16),
                                ("narrow", (1, 8, 8, 3, 24), torch.bfloat16),
                                ("narrow", (1, 8, 8, 16, 272),
                                 torch.bfloat16)):
        x, w, scale, bias = _conv_inputs(shape)
        monkeypatch.setattr(port_fc, "conv_route", lambda *_, r=route: r)
        before = dict(port_fc.fused_conv3x3_bn_relu.launches_by_route)
        with torch.inference_mode(), pytest.raises(RuntimeError, match=route):
            port_fc.fused_conv3x3_bn_relu(x.to(dtype), w.to(dtype), scale,
                                          bias)
        assert port_fc.fused_conv3x3_bn_relu.launches_by_route == before


# (B, H, W, Cin, Cout) of the narrow route: the main path's two 512x512
# shapes (the UNet family's first conv, the TransUnet decoder's last); Cin
# 1, 3, 8 and 16 (a halo pixel of 8 or 16 channels, rows of x staged off or
# on 16-byte chunks) with Cout 16, 64 and 256 (passes of 16 or 64 output
# channels) at odd H and W not a multiple of the 128-pixel chunk: W 300 (one
# tile of 384 columns at Cin <= 8, two of 256 at Cin 16) and, at batch 1,
# W 133; then Cin 5 and 12 with Cout 48 and 96 (passes of 16 and 32), W
# under one chunk and H 1, W 1000 (two tiles of 512 columns) and W 2049.
NARROW_CONV_SHAPES = ([(8, 512, 512, 3, 64), (8, 512, 512, 16, 16)]
                      + [(b, h, w, cin, cout)
                         for b, h, w in ((2, 11, 300), (1, 9, 133))
                         for cin in (1, 3, 8, 16)
                         for cout in (16, 64, 256)]
                      + [(3, 5, 7, 12, 48), (2, 1, 5, 5, 96),
                         (2, 33, 1000, 3, 32), (1, 3, 2049, 16, 16)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", NARROW_CONV_SHAPES)
def test_narrow_route_matches_plain_on_card(monkeypatch, shape):
    """bf16 within two ulps of the output's peak, as the other routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    assert port_fc.conv_route(torch.bfloat16, *shape[3:]) == "narrow"
    args = _conv_inputs(shape)
    out, launched = _conv_on_route(monkeypatch, "narrow", args)
    with torch.inference_mode():
        ref = port_fc.fused_conv3x3_bn_relu_reference(*args)
    assert launched == 1
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs().max().item()
    bound = 2 ** -6 * ref.float().abs().max().item()
    assert err <= bound, (err, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 64), (16, 16), (16, 256)])
def test_narrow_route_reads_no_halo_across_images_on_card(monkeypatch, cin,
                                                          cout):
    """Images 0 and 2 are zeros, image 1 is 100x larger than the rest: a tap
    that read a row of image 1 into the halo of image 0 or 2 would move them
    off relu(bias), which they must equal exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    x, w, scale, bias = _conv_inputs((3, 9, 70, cin, cout), seed=2)
    x[0] = 0
    x[2] = 0
    x[1] *= 100
    out, launched = _conv_on_route(monkeypatch, "narrow",
                                   (x, w, scale, bias))
    assert launched == 1
    with torch.inference_mode():
        ref = port_fc.fused_conv3x3_bn_relu_reference(x, w, scale, bias)
    floor = torch.relu(bias).to(torch.bfloat16).expand(9, 70, cout)
    assert torch.equal(out[0], floor) and torch.equal(out[2], floor)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -6 * ref.float().abs().max().item()


# (B, H, Nq, Nk, Dqk, Dv, masked): the ViT's head width with Nq, Nk off the
# 64-row tiles; CLTR's Dqk != Dv with a mask; one key; the widest widths
# with a single query row; the narrowest with Nk a tile multiple.
ATTN_SHAPES = [(2, 3, 100, 77, 64, 64, False), (3, 2, 70, 90, 64, 32, True),
               (2, 1, 5, 1, 32, 16, False), (1, 2, 1, 130, 128, 128, True),
               (2, 2, 64, 128, 16, 48, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_kernel_matches_plain_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    *dims, masked = shape
    b, h, nq, nk, dqk, dv = dims
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               .cuda().to(dtype)
               for s in ((b, h, nq, dqk), (b, h, nk, dqk), (b, h, nk, dv)))
    mask = None
    if masked:  # row 0 pads its last third; row 1, if any, every key
        mask = torch.zeros(b, nk, dtype=torch.bool)
        mask[0, nk - nk // 3:] = True
        mask[1:2] = True
        mask = mask.cuda()
    before = port_attn.fused_attention.launches
    with torch.inference_mode():
        out = port_attn.fused_attention(q, k, v, key_padding_mask=mask)
        torch.cuda.synchronize()
        ref = port_attn.attention_reference(
            q, k, v, dqk ** -0.5,
            None if mask is None else port_attn.padding_bias(mask))
    assert port_attn.fused_attention.launches == before + 1
    assert out.shape == ref.shape == (b, h, nq, dv) and out.dtype == dtype
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    # relative to max|v|: each output row is a convex combination of rows of
    # v. bf16: both versions round the probabilities (2**-9 of max|v| each)
    # and the output once; f32: sums in other orders (the bound of
    # chip_smoke.py)
    peak = v.float().abs().max().item()
    bound = (1e-5 if dtype == torch.float32 else 2 ** -7) * peak
    assert err <= bound, (err, bound)
    if masked and b > 1:  # every key of row 1 is padding: the mean of v
        mean = v[1].float().mean(dim=1, keepdim=True).expand(h, nq, dv)
        assert (out[1].float() - mean).abs().max().item() <= bound


@pytest.mark.cuda
def test_attention_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    q = torch.randn(1, 2, 8, 64, device="cuda")
    fa = port_attn.fused_attention
    for d in (8, 24, 144):  # not a multiple of 16, or wider than 128
        x = torch.randn(1, 2, 8, d, device="cuda")
        with pytest.raises(ValueError, match="multiples of 16"):
            fa(x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        fa(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    with pytest.raises(TypeError):
        fa(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="v must be"):
        fa(q, q, q[:, :, :4])
    # with autograd recording the call is the train kernels' (no eval launch)
    before = (fa.launches, port_attn.attention_train_forward.launches)
    fa(q.requires_grad_(), q, q).sum().backward()
    assert (fa.launches, port_attn.attention_train_forward.launches) == (
        before[0], before[1] + 1)
    with pytest.raises(ValueError, match="lse must be"):
        port_attn.attention_backward(q, q, q, q, q, q, 0.125)
    with pytest.raises(TypeError):
        port_attn.attention_backward(
            q, q, q, q, torch.zeros(2, 8, device="cuda"), q.bfloat16(), 0.125)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")


# (B*H, Nq, Nk, nk_p, rate): the ViT's padded stride, a ragged shape, and a
# row * nk_p that passes 2**32 (uint32 wraparound) from row 4096 on
MASK_SHAPES = [(6, 64, 1024, None, 0.1), (12, 100, 77, None, 0.3),
               (1, 4200, 8, 1 << 20, 0.5)]


# the grid of the kernel's paths: 128-bit stores (Nk % 16 == 0) and byte
# stores with a ragged tail, one row and many, one bh and many
MASK_SHAPES += [(n_bh, nq, nk, None, 0.1) for n_bh in (1, 96)
                for nq in (1, 100) for nk in (16, 77, 1024, 2000)]


@pytest.mark.cuda
@pytest.mark.parametrize("q_off", [1, 512, 70000])
@pytest.mark.parametrize("shape", MASK_SHAPES[:3])
def test_keep_mask_probe_with_a_query_row_offset_is_bit_exact_on_card(
        shape, q_off):
    """A strip's rows of the mask, from q_off on: the probe against the
    plain hash of the same rows and against the slice of the whole mask."""
    _needs_card()
    n_bh, nq, nk, nk_p, rate = shape
    mask = port_attn.dropout_keep_mask(n_bh, nq, nk, 1234, rate, "cuda",
                                       nk_p=nk_p, q_off=q_off)
    ref = port_attn.dropout_keep(
        1234, n_bh, nq, nk, nk_p or port_attn.dfa_nk_p(nk),
        port_attn.dropout_threshold(rate), row0=q_off, device="cuda")
    assert torch.equal(mask.bool(), ref)
    if q_off < 1000:
        whole = port_attn.dropout_keep_mask(n_bh, q_off + nq, nk, 1234,
                                            rate, "cuda", nk_p=nk_p)
        assert torch.equal(mask, whole[:, q_off:])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MASK_SHAPES)
def test_keep_mask_probe_is_bit_exact_on_card(shape):
    _needs_card()
    n_bh, nq, nk, nk_p, rate = shape
    before = port_attn.dropout_keep_mask.launches
    mask = port_attn.dropout_keep_mask(n_bh, nq, nk, 1234, rate, "cuda",
                                       nk_p=nk_p)
    assert port_attn.dropout_keep_mask.launches == before + 1
    ref = port_attn.dropout_keep(
        1234, n_bh, nq, nk, nk_p or port_attn.dfa_nk_p(nk),
        port_attn.dropout_threshold(rate), device="cuda")
    assert mask.dtype == torch.uint8 and mask.shape == ref.shape
    assert torch.equal(mask.bool(), ref)


def _train_inputs(shape, dtype):
    *dims, masked = shape
    b, h, nq, nk, dqk, dv = dims
    rng = np.random.RandomState(2)
    q, k, v, g = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                  .cuda().to(dtype)
                  for s in ((b, h, nq, dqk), (b, h, nk, dqk), (b, h, nk, dv),
                            (b, h, nq, dv)))
    bias = None
    if masked:  # as in test_attention_kernel_matches_plain_on_card
        mask = torch.zeros(b, nk, dtype=torch.bool)
        mask[0, nk - nk // 3:] = True
        mask[1:2] = True
        bias = port_attn.padding_bias(mask.cuda())
    return q, k, v, g, bias


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_train_kernels_match_plain_on_card(shape, dtype, rate):
    """The train forward (o, lse) and the backward (dq, dk, dv) against
    attention_train_reference and attention_backward_reference, at the
    bounds of chip_smoke.py phase T2: o within the eval bound times
    1 / (1 - rate) of max|v|, lse within 1e-4, each gradient within 2**-6
    (bf16: P and dS rounded at different points) or 1e-5 (f32) of its
    peak, or of its inputs' scale at Nk = 1, where dS cancels."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g, bias = _train_inputs(shape, dtype)
    scale, seed = shape[4] ** -0.5, 77
    args = (q, k, v, scale, bias, seed, rate)
    before = (port_attn.attention_train_forward.launches,
              port_attn.attention_backward.launches)
    o, lse = port_attn.attention_train_forward(*args)
    ref_o, ref_lse = port_attn.attention_train_reference(*args)
    bwd_args = (q, k, v, ref_o, ref_lse, g, scale, bias, seed, rate)
    grads = port_attn.attention_backward(*bwd_args)
    refs = port_attn.attention_backward_reference(*bwd_args)
    torch.cuda.synchronize()
    assert (port_attn.attention_train_forward.launches,
            port_attn.attention_backward.launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert o.shape == ref_o.shape and o.dtype == dtype
    assert lse.shape == ref_lse.shape == (shape[0] * shape[1], shape[2])
    o_bound = ((1e-5 if dtype == torch.float32 else 2 ** -7) / (1 - rate)
               * v.float().abs().max().item())
    assert (o.float() - ref_o.float()).abs().max().item() <= o_bound
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    rel = 1e-5 if dtype == torch.float32 else 2 ** -6

    def amax(t):
        return t.float().abs().max().item()

    # With Nk = 1, P is one-hot and dS = P (dP - D) cancels: dq and dk are 0
    # in exact arithmetic, so only there their bound is the rounding of dP
    # and D, rel times scale * max|g| * max|v| * max|k| (dq) or max|q| (dk).
    # Every other shape holds each gradient to rel times its own peak.
    one_hot = shape[3] == 1
    floor = {"dq": scale * amax(g) * amax(v) * amax(k) if one_hot else 0.0,
             "dk": scale * amax(g) * amax(v) * amax(q) if one_hot else 0.0,
             "dv": 0.0}
    for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
        assert a.shape == r.shape and a.dtype == dtype, name
        assert torch.isfinite(a).all(), name
        err = (a.float() - r.float()).abs().max().item()
        assert err <= rel * max(amax(r), floor[name]), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 2, 7), (5, 0, 3), (0, 0, 8, 64),
                                     (1, 1, 8, 4097)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [ATTN_SHAPES[0], ATTN_SHAPES[1],
                                   ATTN_SHAPES[4]])
def test_train_kernels_with_offsets_match_plain_on_card(shape, dtype,
                                                        offsets):
    """A rank's share of a data-, tensor- or spatially parallel step: the
    train forward and backward with (b_off, h_off, h_total[, q_off]) hash
    the whole batch's batch*head and the whole sequence's query rows,
    against the plain versions with the same offsets, at
    test_train_kernels_match_plain_on_card's bounds (rate 0.3; the wgmma
    widths (64, 64) and (64, 32) in bf16, mma.sync at (16, 48), f32)."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g, bias = _train_inputs(shape, dtype)
    scale, seed, rate = shape[4] ** -0.5, 77, 0.3
    args = (q, k, v, scale, bias, seed, rate)
    o, lse = port_attn.attention_train_forward(*args, offsets=offsets)
    ref_o, ref_lse = port_attn.attention_train_reference(*args,
                                                         offsets=offsets)
    # the offsets move the mask: the call without them gives another o
    assert not torch.equal(ref_o, port_attn.attention_train_reference(
        *args)[0])
    bwd_args = (q, k, v, ref_o, ref_lse, g, scale, bias, seed, rate)
    grads = port_attn.attention_backward(*bwd_args, offsets=offsets)
    refs = port_attn.attention_backward_reference(*bwd_args, offsets=offsets)
    torch.cuda.synchronize()
    o_bound = ((1e-5 if dtype == torch.float32 else 2 ** -7) / (1 - rate)
               * v.float().abs().max().item())
    assert (o.float() - ref_o.float()).abs().max().item() <= o_bound
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    rel = 1e-5 if dtype == torch.float32 else 2 ** -6
    for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= rel * r.float().abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_autograd_on_card_matches_cpu(rate):
    """dropout_flash_attention's gradients in f32 (TF32 off), the kernels on
    the card against the plain versions on the CPU: the same mask from the
    same seed, sums in other orders."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(3)
    arrays = [rng.randn(2, 3, 100, 64).astype(np.float32) for _ in range(3)]
    grads = {}
    for device in ("cuda", "cpu"):
        ts = [torch.from_numpy(a).to(device).requires_grad_() for a in arrays]
        out = port_attn.dropout_flash_attention(*ts, 11, 0.125, rate)
        (out ** 2).sum().backward()
        grads[device] = [t.grad.cpu() for t in ts]
    for a, r in zip(grads["cuda"], grads["cpu"]):
        assert (a - r).abs().max().item() <= 1e-5 * r.abs().max().item()


# (a shape, b shape): 2-D, batched, each side shared by the batch, sizes off
# the 128 x 128 x 16 tiles, a single row and a single column
MINPLUS_SHAPES = [((100, 77), (77, 130)), ((3, 100, 77), (3, 77, 130)),
                  ((64, 64), (5, 64, 40)), ((5, 129, 17), (17, 257)),
                  ((2, 1, 300), (2, 300, 1)), ((4, 128, 128), (128, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("sentinel", [False, True])
@pytest.mark.parametrize("shapes", MINPLUS_SHAPES)
def test_minplus_kernel_equals_plain_on_card(shapes, sentinel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy((rng.rand(*s) * 1000).astype(np.float32)).cuda()
            for s in shapes)
    if sentinel:  # the distance transform's 1e12 "no source here" entries
        b = torch.where(b > 400, 1e12, 0.0).float()
    before = port_mp.minplus.launches
    out = port_mp.minplus(a, b)
    torch.cuda.synchronize()
    assert port_mp.minplus.launches == before + 1
    ref = port_mp.minplus_reference(a, b)
    # one rounded add per candidate and an exact minimum: bit for bit
    assert out.shape == ref.shape and torch.equal(out, ref)
    assert torch.equal(out.cpu(), port_mp.minplus(a.cpu(), b.cpu()))


@pytest.mark.cuda
def test_minplus_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    a = torch.rand(4, 8, 6, device="cuda")
    b = torch.rand(6, 5, device="cuda")
    with pytest.raises(TypeError):
        port_mp.minplus(a.double(), b)
    with pytest.raises(ValueError):
        port_mp.minplus(a, torch.rand(7, 5, device="cuda"))
    with pytest.raises(ValueError):
        port_mp.minplus(a.transpose(1, 2), torch.rand(8, 5, device="cuda"))
    with pytest.raises(ValueError):
        port_mp.minplus(a, b.cpu())
    with pytest.raises(RuntimeError):
        port_mp.minplus(a.requires_grad_(), b)
    before = port_mp.minplus.launches
    with torch.no_grad():
        port_mp.minplus(a, b)
    assert port_mp.minplus.launches == before + 1


@pytest.mark.cuda
def test_distance_transform_on_card_matches_scipy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernel has no CPU mode")
    from scipy.ndimage import distance_transform_edt

    from unet_torch_tpu_torch.losses.functional import (
        euclidean_distance_transform_sq,
    )

    rng = np.random.RandomState(1)
    masks = (rng.rand(3, 70, 45) > 0.2).astype(np.float32)
    out = euclidean_distance_transform_sq(
        torch.from_numpy(masks).cuda()).cpu().numpy()
    for m, o in zip(masks, out):
        np.testing.assert_allclose(o, distance_transform_edt(m) ** 2,
                                   rtol=1e-6)


# (B, Q, T, max_iters, share of valid slots): ragged sizes, one query, T = Q
# (hundreds of rounds), more targets than one pass of the block's threads,
# and max_iters too low to converge (the greedy tail)
AUCTION_SHAPES = [(5, 77, 13, 20000, 0.7), (3, 1, 1, 20000, 1.0),
                  (2, 40, 40, 20000, 1.0), (2, 2000, 1100, 20000, 0.9),
                  (4, 40, 12, 1, 1.0), (3, 300, 64, 3, 0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", AUCTION_SHAPES)
def test_auction_kernel_equals_plain_on_card(shape):
    _needs_card()
    from unet_torch_tpu_torch.kernels import auction as port_au

    b, q, t, max_iters, share = shape
    rng = np.random.RandomState(q * 100 + t)
    costs = torch.from_numpy((rng.rand(b, q, t) * 10).astype(np.float32))
    valid = torch.from_numpy(rng.rand(b, t) < share)
    valid[0] = False  # an instance without targets leaves at once
    costs = torch.where(valid[:, None, :], costs, 1e9).cuda()
    valid = valid.cuda()
    before = port_au.auction_lsap.launches
    out = port_au.auction_lsap(costs, valid, max_iters, stats=True)
    torch.cuda.synchronize()
    assert port_au.auction_lsap.launches == before + 1
    ref = port_au.auction_lsap_reference(costs, valid, max_iters, stats=True)
    # the same rounds in the same f32 order: equal, not close
    for o, r in zip(out, ref):
        assert o.dtype == torch.int32 and torch.equal(o, r)
    match, rounds, _ = out
    assert rounds[0] == 0 and not match[0].any()
    for z in range(b):
        n = int(valid[z].sum())
        picked = match[z][valid[z]].tolist()
        assert len(set(picked)) == n and all(0 <= p < q for p in picked)
    cpu = port_au.auction_lsap(costs.cpu(), valid.cpu(), max_iters)
    assert torch.equal(match.cpu(), cpu)


# (B, Q, T, costs, how the one-bidder rounds get a row's top two): uniform
# costs in [0, 10) or "contended" ones (a per-query cost shared by every
# target plus noise, so that targets compete for the same queries). A long
# tail at T = Q from the candidate cache (256: 2913 rounds, 2725 of them
# with one bidder) and from the rows where the cache does not fit (400: 3487
# rounds, 2386 with one bidder); CLTR's Q = 2000 with contention (168 and 89
# rounds); Q % 4 != 0 (scalar loads); a Q so large that the cache does not
# fit (16-byte loads, every row read; 28 and 9 rounds).
AUCTION_PATH_CASES = [(2, 256, 256, "uniform", "cache"),
                      (2, 400, 400, "uniform", "rows"),
                      (2, 2000, 64, "contended", "cache"),
                      (2, 255, 250, "uniform", "cache"),
                      (2, 12000, 64, "contended", "rows")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", AUCTION_PATH_CASES)
def test_auction_kernel_paths_equal_plain_on_card(case):
    _needs_card()
    from unet_torch_tpu_torch.kernels import auction as port_au

    b, q, t, kind, path = case
    # the candidate cache (644 bytes a target) fits beside 16 bytes a query
    # and a target and the block's scratch (csrc/auction_lsap.cu::smem_bytes)
    fits = 16 * (q + t) + port_au._SCRATCH_BYTES + 644 * t <= \
        port_au._MAX_SMEM
    assert fits == (path == "cache")
    rng = np.random.RandomState(q * 100 + t)
    costs = rng.rand(b, q, t) * 10
    if kind == "contended":
        costs = rng.rand(b, q, 1) * 10 + rng.rand(b, q, t)
    costs = torch.from_numpy(costs.astype(np.float32)).cuda()
    valid = torch.ones(b, t, dtype=torch.bool, device="cuda")
    out = port_au.auction_lsap(costs, valid, stats=True)
    per_round = []
    ref = port_au.auction_lsap_reference(costs, valid, stats=True,
                                         per_round=per_round)
    for o, r in zip(out, ref):
        assert o.dtype == torch.int32 and torch.equal(o, r)
    match, rounds, bids = out
    assert int(rounds.min()) > 1
    for z in range(b):
        assert len(set(match[z].tolist())) == t
    if q == t:  # the long tail: most of the slowest instance's rounds have
        # one bidder
        z = int(rounds.argmax())
        lone = sum(int(r[z]) == 1 for r in per_round)
        assert int(rounds[z]) > 1000 and 2 * lone > int(rounds[z])


@pytest.mark.cuda
def test_auction_kernel_rejects_what_it_does_not_take():
    _needs_card()
    from unet_torch_tpu_torch.kernels import auction as port_au

    costs = torch.rand(2, 9, 4, device="cuda")
    valid = torch.ones(2, 4, dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError):
        port_au.auction_lsap(costs.double(), valid)
    with pytest.raises(TypeError):
        port_au.auction_lsap(costs, valid.float())
    with pytest.raises(ValueError):
        port_au.auction_lsap(costs, valid.cpu())
    with pytest.raises(ValueError):  # 16 bytes a query: past shared memory
        port_au.auction_lsap(torch.rand(1, 20000, 2, device="cuda"),
                             valid[:1, :2])
    # costs under autograd are detached, as the JAX step stops the gradient
    out = port_au.auction_lsap_batched(costs.view(1, 2, 9, 4).requires_grad_(),
                                       valid.view(1, 2, 4))
    assert out.shape == (1, 2, 4) and not out.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 200, 200), (1, 2, 100, 77),
                                   (3, 2, 64, 1), (1, 6, 1, 130),
                                   (3, 4, 100, 77)])
def test_packed_attention_probe_matches_plain_on_card(shape):
    _needs_card()
    b, h, nq, nk = shape
    rng = np.random.RandomState(nq)
    q, k, v = (torch.from_numpy(rng.randn(b, h, n, 64).astype(np.float32))
               .cuda().bfloat16() for n in (nq, nk, nk))
    ref = port_attn.attention_reference(q, k, v, 0.125)
    # as the flash forward: 2**-7 of max|v| in bf16
    bound = 2.0 ** -7 * v.float().abs().max().item()
    before = port_attn.packed2_attention.launches
    out = port_attn.packed2_attention(q, k, v)
    torch.cuda.synchronize()
    assert port_attn.packed2_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= bound
    with pytest.raises(ValueError):  # an odd number of heads
        port_attn.packed2_attention(q[:, :1], k[:, :1], v[:, :1])
    with pytest.raises((ValueError, TypeError)):
        port_attn.packed2_attention(q.float(), k.float(), v.float())


# The bf16 wgmma kernels: (Dqk, Dv) of the ViT, of CLTR's self-attentions and
# of CLTR's cross-attention, each compiled at its own widths. Nq and Nk run
# over one row, sizes off the 64- and 128-row tiles, exactly one key tile
# (CLTR's memory) and CLTR's 2000 queries.
WGMMA_WIDTHS = [(64, 64), (32, 32), (64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nk", [1, 64, 77, 2000])
@pytest.mark.parametrize("nq", [1, 100, 129, 2000])
@pytest.mark.parametrize("widths", WGMMA_WIDTHS)
def test_wgmma_kernels_match_plain_on_card(widths, nq, nk, masked):
    """The eval forward, the train forward (o, lse) and the backward (dq, dk,
    dv) of each wgmma instance against the plain versions, at rate 0 and at
    rate 0.1 under two seeds, with and without the key-padding bias (batch
    row 1 then has every key padded), at chip_smoke.py T2's bounds: o within
    2**-7 / (1 - rate) of max|v|, lse within 1e-4, each gradient within 2**-6
    of its peak (of its inputs' scale at Nk = 1, where dS cancels)."""
    _needs_card()
    dqk, dv = widths
    dtype = torch.bfloat16
    assert port_attn.attention_route(dtype, dqk, dv) == "wgmma"
    shape = (2, 2, nq, nk, dqk, dv, masked)
    q, k, v, g, bias = _train_inputs(shape, dtype)
    scale = dqk ** -0.5
    vmax = v.float().abs().max().item()

    def amax(t):
        return t.float().abs().max().item()

    with torch.inference_mode():
        mask = None if bias is None else bias < -1.0
        out = port_attn.fused_attention(q, k, v, key_padding_mask=mask)
        ref = port_attn.attention_reference(q, k, v, scale, bias)
    assert out.shape == ref.shape and out.dtype == dtype
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2 ** -7 * vmax
    if masked:  # every key of row 1 is padding: the mean of v
        mean = v[1].float().mean(dim=1, keepdim=True).expand(2, nq, dv)
        assert (out[1].float() - mean).abs().max().item() <= 2 ** -7 * vmax

    one_hot = nk == 1
    floor = {"dq": scale * amax(g) * amax(v) * amax(k) if one_hot else 0.0,
             "dk": scale * amax(g) * amax(v) * amax(q) if one_hot else 0.0,
             "dv": 0.0}
    for rate, seed in ((0.0, 0), (0.1, 77), (0.1, 1234)):
        args = (q, k, v, scale, bias, seed, rate)
        before = (port_attn.attention_train_forward.launches,
                  port_attn.attention_backward.launches)
        o, lse = port_attn.attention_train_forward(*args)
        ref_o, ref_lse = port_attn.attention_train_reference(*args)
        bwd_args = (q, k, v, ref_o, ref_lse, g, scale, bias, seed, rate)
        grads = port_attn.attention_backward(*bwd_args)
        refs = port_attn.attention_backward_reference(*bwd_args)
        torch.cuda.synchronize()
        assert (port_attn.attention_train_forward.launches,
                port_attn.attention_backward.launches) == (before[0] + 1,
                                                           before[1] + 1)
        assert o.shape == ref_o.shape and o.dtype == dtype
        assert lse.shape == ref_lse.shape == (4, nq)
        o_err = (o.float() - ref_o.float()).abs().max().item()
        assert o_err <= 2 ** -7 / (1 - rate) * vmax, (rate, seed, o_err)
        assert (lse - ref_lse).abs().max().item() <= 1e-4, (rate, seed)
        for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
            assert a.shape == r.shape and a.dtype == dtype, name
            assert torch.isfinite(a).all(), (name, rate, seed)
            err = (a.float() - r.float()).abs().max().item()
            assert err <= 2 ** -6 * max(amax(r), floor[name]), (
                name, rate, seed, err)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_general_route_matches_plain_on_card(rate):
    """Widths that only the mma.sync kernels take (Dqk 128, Dv 16), ragged
    and masked: forward, train forward and backward against the plain
    versions at T2's bounds."""
    _needs_card()
    dtype = torch.bfloat16
    assert port_attn.attention_route(dtype, 128, 16) == "mma.sync"
    q, k, v, g, bias = _train_inputs((2, 3, 100, 77, 128, 16, True), dtype)
    scale, seed = 128 ** -0.5, 5
    vmax = v.float().abs().max().item()
    args = (q, k, v, scale, bias, seed, rate)
    o, lse = port_attn.attention_train_forward(*args)
    ref_o, ref_lse = port_attn.attention_train_reference(*args)
    bwd_args = (q, k, v, ref_o, ref_lse, g, scale, bias, seed, rate)
    grads = port_attn.attention_backward(*bwd_args)
    refs = port_attn.attention_backward_reference(*bwd_args)
    torch.cuda.synchronize()
    assert (o.float() - ref_o.float()).abs().max().item() <= (
        2 ** -7 / (1 - rate) * vmax)
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= 2 ** -6 * r.float().abs().max().item(), (name, err)
    if rate == 0.0:
        with torch.inference_mode():
            out = port_attn.fused_attention(q, k, v,
                                            key_padding_mask=bias < -1.0)
        assert (out.float() - ref_o.float()).abs().max().item() <= (
            2 ** -7 * vmax)


@pytest.mark.cuda
def test_wgmma_autograd_on_card_matches_cpu():
    """dropout_flash_attention's gradients through the bf16 wgmma kernels on
    the card against the plain versions on the CPU in bf16: the same mask
    from the same seed; dq's f32 sums arrive in any order."""
    _needs_card()
    rng = np.random.RandomState(4)
    arrays = [rng.randn(2, 3, 200, 32).astype(np.float32) for _ in range(3)]
    grads = {}
    for device in ("cuda", "cpu"):
        ts = [torch.from_numpy(a).to(device, torch.bfloat16).requires_grad_()
              for a in arrays]
        out = port_attn.dropout_flash_attention(*ts, 11, 32 ** -0.5, 0.1)
        (out.float() ** 2).sum().backward()
        grads[device] = [t.grad.float().cpu() for t in ts]
    for a, r in zip(grads["cuda"], grads["cpu"]):
        assert (a - r).abs().max().item() <= 2 ** -5 * r.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("widths", WGMMA_WIDTHS)
def test_wgmma_kernels_take_a_negative_scale_on_card(widths):
    """A scale <= 0 reverses the order of the scores, so the wgmma kernels
    may not fold it into the exponent: they take their general instance, as
    with a bias. Forward, train forward and backward at T2's bounds."""
    _needs_card()
    dqk, dv = widths
    dtype = torch.bfloat16
    q, k, v, g, _ = _train_inputs((2, 2, 100, 77, dqk, dv, False), dtype)
    scale, seed, rate = -(dqk ** -0.5), 3, 0.1
    vmax = v.float().abs().max().item()
    args = (q, k, v, scale, None, seed, rate)
    o, lse = port_attn.attention_train_forward(*args)
    ref_o, ref_lse = port_attn.attention_train_reference(*args)
    bwd_args = (q, k, v, ref_o, ref_lse, g, scale, None, seed, rate)
    grads = port_attn.attention_backward(*bwd_args)
    refs = port_attn.attention_backward_reference(*bwd_args)
    torch.cuda.synchronize()
    assert (o.float() - ref_o.float()).abs().max().item() <= (
        2 ** -7 / (1 - rate) * vmax)
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= 2 ** -6 * r.float().abs().max().item(), (name, err)
    with torch.inference_mode():
        out = port_attn.fused_attention(q, k, v, scale)
        ref = port_attn.attention_reference(q, k, v, scale)
    assert (out.float() - ref.float()).abs().max().item() <= 2 ** -7 * vmax


@pytest.mark.cuda
@pytest.mark.parametrize("widths", WGMMA_WIDTHS)
def test_wgmma_backward_with_a_very_negative_lse_on_card(widths):
    """Scores near -140 or lower put every row's lse below -90, and Nk = 77
    leaves key rows of the last tile past Nk: there K is zero and the
    backward's recomputed probability exp(-lse) overflows to inf. Those rows
    must reach no result: dq, dk and dv finite and at T2's bounds (dq = dS K
    cancels against the keys' common offset, as at Nk = 1, so it is held to
    its inputs' scale; lse to 1e-4 of its size, f32 sums of 25 a product)."""
    _needs_card()
    dqk, dv = widths
    dtype = torch.bfloat16
    q, k, v, g, _ = _train_inputs((2, 2, 100, 77, dqk, dv, False), dtype)
    q, k = (0.1 * q - 5.0).to(dtype), (0.1 * k + 5.0).to(dtype)
    scale, seed = dqk ** -0.5, 9
    for rate in (0.0, 0.1):
        args = (q, k, v, scale, None, seed, rate)
        o, lse = port_attn.attention_train_forward(*args)
        ref_o, ref_lse = port_attn.attention_train_reference(*args)
        assert ref_lse.max().item() < -90.0
        assert (lse - ref_lse).abs().max().item() <= (
            1e-4 * ref_lse.abs().max().item())
        bwd_args = (q, k, v, ref_o, ref_lse, g, scale, None, seed, rate)
        grads = port_attn.attention_backward(*bwd_args)
        refs = port_attn.attention_backward_reference(*bwd_args)
        torch.cuda.synchronize()
        for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
            assert torch.isfinite(a).all(), (name, rate)
            err = (a.float() - r.float()).abs().max().item()
            peak = r.float().abs().max().item()
            if name == "dq":
                peak = max(peak, scale * g.float().abs().max().item()
                           * v.float().abs().max().item()
                           * k.float().abs().max().item())
            assert err <= 2 ** -6 * peak, (name, rate, err)


@pytest.mark.cuda
@pytest.mark.parametrize("bars,window", [(64, None), (8, 16)])
def test_native_pairing_of_a_card_likelihood_equals_numpy(bars, window):
    """The host pairing (native/ph0.cpp) of the likelihood a UNet forward
    produced on the card, the whole map or its windows, equal to the numpy
    oracle's."""
    _needs_card()
    from unet_torch_tpu_torch.losses import topo
    from unet_torch_tpu_torch.models.unet import build_model
    from unet_torch_tpu_torch.native import ph0

    model = build_model("single", n_channels=3, n_classes=1, base=8,
                        generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 64, 3)
                         .astype(np.float32))
    with torch.no_grad():
        lik = torch.sigmoid(model.cuda().eval()(x.cuda()))[..., 0].cpu()
    for m in lik.numpy():
        crops = [m] if window is None else [
            np.ascontiguousarray(m[i:i + window, j:j + window])
            for i in range(0, 64, window) for j in range(0, 64, window)]
        for crop in crops:
            for a, b in zip(ph0.superlevel_ph0(crop, bars),
                            topo._superlevel_ph0_np(crop, bars)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["TopoLoss", "TopoCount"])
def test_topo_losses_on_card_match_cpu(key):
    """The single-call losses on CUDA logits (the pairing on the host, the
    gather on the card) against the same call on the CPU. The logits are
    spread 0.0078 apart (a jittered permutation of a grid), so the two
    devices' sigmoids order the pixels alike and pair alike; the losses
    and gradients then agree to f32 rounding."""
    _needs_card()
    from unet_torch_tpu_torch.losses import calc_loss

    rng = np.random.RandomState(1)
    grid = np.linspace(-4.0, 4.0, 2 * 32 * 32)
    logits = torch.from_numpy(
        (rng.permutation(grid) + rng.uniform(0, 1e-3, grid.size))
        .reshape(2, 32, 32, 1).astype(np.float32))
    target = torch.from_numpy((rng.rand(2, 32, 32) > 0.97)
                              .astype(np.float32))
    results = []
    for dev in ("cpu", "cuda"):
        p = logits.detach().to(dev).requires_grad_()
        loss = calc_loss(p, target.to(dev), loss_type=key, num_classes=1)
        loss.backward()
        results.append((loss.item(), p.grad.cpu().numpy()))
    assert results[0][0] > 0
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-5)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-5,
                               atol=1e-6)


def _seeded_transunet(model_type, size, num_classes, seed=0):
    """R50-ViT-B/16 at size x size with seeded weights, position
    embeddings and BN statistics, the decoders' and heads' convs drawn
    kaiming-normal (torch's default conv init shrinks the variance 3x per
    conv, so BN shifts, not the image, would decide the logits)."""
    from unet_torch_tpu_torch.models.transunet.vit import build_transunet

    gen = torch.Generator().manual_seed(seed)
    model = build_transunet(model_type, img_size=size,
                            num_classes=num_classes, generator=gen)
    with torch.no_grad():
        pos = model.transformer.embeddings.position_embeddings
        pos.copy_(torch.randn(pos.shape, generator=gen) * 0.02)
        for name, m in model.named_modules():
            if (isinstance(m, torch.nn.Conv2d)
                    and not name.startswith("transformer")):
                torch.nn.init.kaiming_normal_(m.weight, generator=gen)
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,n_heads", [("multi_task_regTU", 2),
                                                ("multitask_em", 6)])
def test_multihead_transunet_forward_launches_by_route_on_card(model_type,
                                                               n_heads):
    """The two-head and six-head bf16 eval forwards at full width: each
    decoder's nine convs on the fused-conv kernel, 8 on wgmma and the
    16-channel tail on the narrow route, and the encoder's 12 attention
    launches."""
    _needs_card()
    # f32 parameters and a bf16 input, as make_predict_fn serves a model
    model = _seeded_transunet(model_type, 128, 1).cuda().eval()
    x = torch.randn(2, 128, 128, 3, device="cuda", dtype=torch.bfloat16)
    port_fc.reset_launches()
    before = port_attn.fused_attention.launches
    with torch.inference_mode():
        outs = model(x)
        torch.cuda.synchronize()
    assert len(outs) == n_heads
    assert all(o.shape == (2, 128, 128, 1) and torch.isfinite(o).all()
               for o in outs)
    assert port_fc.fused_conv3x3_bn_relu.launches == 9 * n_heads
    assert port_fc.fused_conv3x3_bn_relu.launches_by_route == {
        "wgmma": 8 * n_heads, "narrow": n_heads, "mma.sync": 0, "reg": 0}
    assert port_attn.fused_attention.launches == before + 12


@pytest.mark.cuda
def test_vis_runs_no_attention_kernel_on_card():
    """vis=True on CUDA tensors: the plain attention (no attention launch),
    12 layers of weights kept, and the f32 logits within chip_smoke.py's
    phase-9 bound (1e-4 of the logits' peak) of the kernel path's."""
    _needs_card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _seeded_transunet("TransUnet", 128, 3).cuda().eval()
    vis = copy.deepcopy(model)
    for layer in vis.transformer.encoder.layer:  # as vis=True builds them
        layer.attn.vis = True
    x = torch.randn(1, 128, 128, 3, device="cuda")
    with torch.inference_mode():
        ref = model(x)
        torch.cuda.synchronize()
        before = port_attn.fused_attention.launches
        out = vis(x)
        torch.cuda.synchronize()
    assert port_attn.fused_attention.launches == before
    weights = vis.attn_weights
    assert len(weights) == 12 and all(
        w.shape == (1, 12, 64, 64) and w.is_cuda for w in weights)
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err
