"""The port's fused conv3x3+BN+ReLU (unet_torch_tpu_torch/kernels/fused_conv.py)
against the JAX package's: the plain version against the Pallas kernel in
interpret mode and the XLA reference on the CPU, and the dispatcher's
routing. The Hopper kernel itself is held against the plain version in
test_torch_port_kernel_cuda.py, on a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet_torch_tpu.kernels import fused_conv as jax_fc
from unet_torch_tpu_torch.kernels import fused_conv as port_fc

# (2,16,32,8) and (1,13,16,4) are tests/test_fused_conv.py's shapes (odd H in
# the second); (1,9,7,3) is the ragged Cin=3 of the UNet's first conv with an
# odd W.
SHAPES = [(2, 16, 32, 8), (1, 13, 16, 4), (1, 9, 7, 3)]
COUT = 8


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    cin = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, cin, COUT) * 0.1).astype(np.float32)
    gamma = (rng.rand(COUT) + 0.5).astype(np.float32)
    beta = rng.randn(COUT).astype(np.float32)
    mean = (rng.randn(COUT) * 0.1).astype(np.float32)
    var = (rng.rand(COUT) + 0.5).astype(np.float32)
    return x, k, (gamma, beta, mean, var)


def test_fold_bn_matches_jax():
    _, _, bn = _inputs(SHAPES[0])
    ref = jax_fc.fold_bn(*(jnp.asarray(a) for a in bn))
    ours = port_fc.fold_bn(*(torch.from_numpy(a) for a in bn))
    for r, o in zip(ref, ours):
        # same f32 ops in the same order; 1 ulp slack for sqrt/div rounding
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_pallas_and_xla(shape):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, k, bn = _inputs(shape)
    scale, bias = (np.array(a) for a in
                   jax_fc.fold_bn(*(jnp.asarray(a) for a in bn)))
    pallas = jax_fc.fused_conv3x3_bn_relu_pallas(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(bias),
        th=4, interpret=True)
    xla = jax_fc.fused_conv3x3_bn_relu_reference(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(bias))
    ours = port_fc.fused_conv3x3_bn_relu_reference(
        torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(scale),
        torch.from_numpy(bias))
    assert ours.shape == shape[:3] + (COUT,)
    assert ours.dtype == torch.float32
    # the bound of tests/test_fused_conv.py: f32 sums in another order
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(xla), atol=1e-4,
                               rtol=1e-4)


def test_dispatch_takes_plain_version_on_cpu():
    x, k, bn = _inputs(SHAPES[1])
    scale, bias = port_fc.fold_bn(*(torch.from_numpy(a) for a in bn))
    args = (torch.from_numpy(x), torch.from_numpy(k), scale, bias)
    before = port_fc.fused_conv3x3_bn_relu.launches
    out = port_fc.fused_conv3x3_bn_relu(*args)
    assert port_fc.fused_conv3x3_bn_relu.launches == before
    assert torch.equal(out, port_fc.fused_conv3x3_bn_relu_reference(*args))


def test_dispatch_raises_off_cpu_and_cuda():
    x = torch.empty((1, 4, 4, 3), device="meta")
    w = torch.empty((3, 3, 3, 8), device="meta")
    s = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="no fused conv"):
        port_fc.fused_conv3x3_bn_relu(x, w, s, s)
