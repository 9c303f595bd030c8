"""The port's plain min-plus product (unet_torch_tpu_torch/kernels/minplus.py)
against the JAX package's Pallas kernel in interpret mode and its reference,
and the squared Euclidean distance transform built on it against scipy and
the JAX package. Every candidate is one rounded f32 add and the minimum is
exact, so the products are held equal, not close."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet_torch_tpu.losses import functional as JF
from unet_torch_tpu_torch.kernels import minplus as port_mp
from unet_torch_tpu_torch.losses import functional as PF

# the package's __init__ exports the function under the module's name
jax_mp = importlib.import_module("unet_torch_tpu.kernels.minplus")

# (M, K, N): inside one 32^3 tile, ragged across several, a single row
SHAPES = [(20, 17, 9), (33, 70, 45), (64, 32, 96), (1, 50, 40)]


def _operands(shape, seed, sentinel=False):
    m, k, n = shape
    rng = np.random.RandomState(seed)
    a = (rng.rand(m, k) * 1000).astype(np.float32)
    b = (rng.rand(k, n) * 1000).astype(np.float32)
    if sentinel:
        b = np.where(b > 400, 1e12, 0.0).astype(np.float32)
    return a, b


@pytest.mark.parametrize("sentinel", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_equals_pallas_interpret_and_jax_reference(shape, sentinel):
    a, b = _operands(shape, seed=sum(shape), sentinel=sentinel)
    ours = port_mp.minplus_reference(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy()
    pallas = np.asarray(jax_mp.minplus_pallas(
        jnp.asarray(a), jnp.asarray(b), tm=32, tn=32, tk=32, interpret=True))
    ref = np.asarray(jax_mp.minplus_reference(jnp.asarray(a), jnp.asarray(b)))
    assert ours.shape == pallas.shape and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("shared", ["none", "a", "b"])
def test_batched_and_broadcast_equal_the_2d_products(shared):
    rng = np.random.RandomState(3)
    a = (rng.rand(4, 21, 13) * 100).astype(np.float32)
    b = (rng.rand(4, 13, 30) * 100).astype(np.float32)
    if shared == "a":
        a = a[0]
    if shared == "b":
        b = b[0]
    out = port_mp.minplus(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert out.shape == (4, 21, 30)
    for z in range(4):
        ref = np.asarray(jax_mp.minplus_reference(
            jnp.asarray(a if a.ndim == 2 else a[z]),
            jnp.asarray(b if b.ndim == 2 else b[z])))
        np.testing.assert_array_equal(out[z], ref)


def test_wrapper_routes_a_cpu_tensor_to_the_plain_version_and_counts_nothing():
    a, b = (torch.from_numpy(x) for x in _operands((9, 8, 7), 0))
    before = port_mp.minplus.launches
    out = port_mp.minplus(a, b)
    assert port_mp.minplus.launches == before
    assert out.shape == (9, 7)
    assert torch.equal(out, port_mp.minplus_reference(a, b))


@pytest.mark.parametrize("a_shape,b_shape", [((3, 4), (5, 6)),
                                             ((2, 3, 4), (3, 4, 6)),
                                             ((4,), (4, 6)),
                                             ((0, 4), (4, 6))])
def test_wrapper_raises_on_shapes_that_do_not_multiply(a_shape, b_shape):
    with pytest.raises(ValueError):
        port_mp.minplus(torch.zeros(a_shape), torch.zeros(b_shape))


def _masks(seed, n=3, h=40, w=28):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    masks = np.zeros((n, h, w), np.float32)
    for m in masks:
        for cy, cx, r in zip(rng.randint(0, h, 4), rng.randint(0, w, 4),
                             rng.randint(2, 7, 4)):
            m[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    return masks


def test_distance_transform_matches_scipy_and_jax():
    from scipy.ndimage import distance_transform_edt

    masks = _masks(0)
    out = PF.euclidean_distance_transform_sq(torch.from_numpy(masks)).numpy()
    assert out.shape == masks.shape and out.dtype == np.float32
    for m, o in zip(masks, out):
        # squared distances are integers below 2^24: exact in f32; scipy
        # returns the root, whose square is off by an ulp of f64
        np.testing.assert_array_equal(
            o, np.rint(distance_transform_edt(m) ** 2))
        np.testing.assert_array_equal(
            o, np.asarray(JF.euclidean_distance_transform_sq(jnp.asarray(m))))
    single = PF.euclidean_distance_transform_sq(torch.from_numpy(masks[0]))
    np.testing.assert_array_equal(single.numpy(), out[0])


@pytest.mark.parametrize("fill", [0.0, 1.0])
def test_distance_transform_of_constant_masks(fill):
    """All background: 0 everywhere. No background: the 1e12 sentinel, as in
    the JAX package."""
    mask = np.full((12, 9), fill, np.float32)
    out = PF.euclidean_distance_transform_sq(torch.from_numpy(mask)).numpy()
    ref = np.asarray(JF.euclidean_distance_transform_sq(jnp.asarray(mask)))
    np.testing.assert_array_equal(out, ref)
    assert (out == (1e12 if fill else 0.0)).all()


def test_distance_field_matches_jax_per_image():
    """Blob masks, an all-zero image (field 0) and an all-one image."""
    masks = _masks(1, n=4)
    masks[2] = 0
    masks[3] = 1
    ours = PF._distance_field(torch.from_numpy(masks)).numpy()
    for m, o in zip(masks, ours):
        ref = np.asarray(JF._distance_field(jnp.asarray(m)))
        np.testing.assert_allclose(o, ref, rtol=1e-6)
    assert (ours[2] == 0).all()


def test_distance_transform_has_no_gradient():
    x = torch.rand(2, 8, 8, requires_grad=True)
    assert not PF.euclidean_distance_transform_sq(x).requires_grad
