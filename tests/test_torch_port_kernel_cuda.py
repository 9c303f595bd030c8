"""The Hopper fused conv3x3+BN+ReLU kernel against its plain PyTorch version,
on a CUDA card. Skips without one: the kernel has no CPU mode.

This file imports no JAX, so that it runs where only the port is installed:

    python -m pytest tests/test_torch_port_kernel_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from unet_torch_tpu_torch.kernels import fused_conv as port_fc

# (B, H, W, Cin, Cout): tests/test_fused_conv.py's shapes (odd H in the
# second), the ragged Cin=3 of the UNet's first conv with an odd W, odd H and
# W with Cin=64, and a K and a Cout that end inside a tile (Cin=24: 216 taps;
# Cout=136: two 128-wide N tiles). The bf16 shapes with Cin and Cout
# multiples of 8 take the pipelined mainloop, the others the register one.
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
    before = port_fc.fused_conv3x3_bn_relu.launches
    with torch.inference_mode():
        out = port_fc.fused_conv3x3_bn_relu(xd, kd, scale, bias)
        torch.cuda.synchronize()
        ref = port_fc.fused_conv3x3_bn_relu_reference(xd, kd, scale, bias)
    assert port_fc.fused_conv3x3_bn_relu.launches == before + 1
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
