"""The port's attention (unet_torch_tpu_torch/kernels/attention.py) against the
JAX package's Pallas kernels in interpret mode on the CPU (as
tests/test_kernels.py runs them), and the dispatcher's routing. The Hopper
kernel itself is held against the plain version in
test_torch_port_kernel_cuda.py, on a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet_torch_tpu.kernels.attention import (
    _attention_flash,
    _attention_pallas,
    fused_attention as jax_fused_attention,
)
from unet_torch_tpu_torch.kernels import attention as port_attn


def _qkv(b, h, nq, nk, dqk, dv, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, nq, dqk).astype(np.float32),
            rng.randn(b, h, nk, dqk).astype(np.float32),
            rng.randn(b, h, nk, dv).astype(np.float32))


def _mask(b, nk, starts):
    """(B, Nk) key-padding mask: row i pads keys from starts[i] on."""
    mask = np.zeros((b, nk), bool)
    for i, s in enumerate(starts):
        mask[i, s:] = True
    return mask


def _bias(mask):
    return np.where(mask, -1e30, 0.0).astype(np.float32)


def _port(q, k, v, scale=None, mask=None):
    return port_attn.fused_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=scale,
        key_padding_mask=None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("shape", [(2, 4, 64, 48, 32, 16),  # test_kernels.py
                                   (1, 3, 17, 33, 64, 64)])
def test_plain_matches_whole_sequence_pallas(shape):
    q, k, v = _qkv(*shape)
    scale = shape[4] ** -0.5
    ref = _attention_pallas(*(jnp.asarray(a) for a in (q, k, v)), scale,
                            interpret=True)
    ours = _port(q, k, v, scale)
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    # the bound of tests/test_kernels.py: f32 sums in another order
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_plain_matches_whole_sequence_pallas_with_bias():
    # tests/test_kernels.py's masked shape, Dqk != Dv
    q, k, v = _qkv(2, 3, 70, 90, 32, 16, seed=3)
    mask = _mask(2, 90, (60, 75))
    ref = _attention_pallas(*(jnp.asarray(a) for a in (q, k, v)),
                            32 ** -0.5, bias=jnp.asarray(_bias(mask)),
                            interpret=True)
    ours = _port(q, k, v, mask=mask)  # default scale is Dqk ** -0.5
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_flash_pallas(masked):
    """Small tiles: 3 query tiles (the last one padded) and 3 key tiles of
    32 with 6 padded columns, Dqk != Dv."""
    q, k, v = _qkv(2, 2, 40, 90, 32, 16, seed=4)
    mask = _mask(2, 90, (50, 89)) if masked else None
    ref = _attention_flash(
        *(jnp.asarray(a) for a in (q, k, v)), 32 ** -0.5,
        bias=None if mask is None else jnp.asarray(_bias(mask)),
        block_q=16, block_k=32, interpret=True)
    ours = _port(q, k, v, mask=mask)
    # the bound of tests/test_kernels.py's flash test
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=2e-5)


def test_plain_matches_pallas_in_bf16():
    """bf16 in and out: both round the probabilities to bf16 and sum the
    second product in f32. They differ only in where p is normalised and
    rounded, so by at most two output roundings and 2**-9 of max|v| each
    (2**-7 of max|v| in all)."""
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv(1, 2, 24, 40, 32, 32))
    ref = np.asarray(_attention_pallas(*(jnp.asarray(a) for a in (q, k, v)),
                                       32 ** -0.5, interpret=True),
                     np.float32)
    ours = port_attn.fused_attention(
        *(torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
          for a in (q, k, v)))
    assert ours.dtype == torch.bfloat16
    bound = 2 ** -7 * np.abs(np.asarray(v, np.float32)).max()
    assert np.abs(ours.float().numpy() - ref).max() <= bound


def test_all_masked_row_gets_the_mean_of_v():
    """The port follows _attention_pallas: a row whose keys are all padding
    sees equal -1e30 scores and averages its Nk rows of v. The JAX package
    disagrees with itself there: its einsum fallback gives NaN, and
    _attention_flash also averages over its zero-padded columns
    (sum(v) / block_k)."""
    nk = 20
    q, k, v = _qkv(2, 2, 8, nk, 16, 16, seed=5)
    mask = _mask(2, nk, (12, 0))  # row 1: every key is padding
    mean = v[1].mean(axis=1, keepdims=True)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(_attention_pallas(jq, jk, jv, 0.25,
                                          bias=jnp.asarray(_bias(mask)),
                                          interpret=True))
    ours = _port(q, k, v, 0.25, mask).numpy()
    np.testing.assert_allclose(pallas[1], np.broadcast_to(mean, (2, 8, 16)),
                               atol=1e-6)
    np.testing.assert_allclose(ours, pallas, atol=1e-5)

    einsum = np.asarray(jax_fused_attention(jq, jk, jv, 0.25,
                                            key_padding_mask=jnp.asarray(mask),
                                            use_pallas=False))
    assert np.isnan(einsum[1]).all() and np.isfinite(einsum[0]).all()
    flash = np.asarray(_attention_flash(jq, jk, jv, 0.25,
                                        bias=jnp.asarray(_bias(mask)),
                                        block_k=128, interpret=True))
    np.testing.assert_allclose(
        flash[1], np.broadcast_to(v[1].sum(axis=1, keepdims=True) / 128,
                                  (2, 8, 16)), atol=1e-6)


def test_dispatch_takes_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 8, 16, 16))
    before = port_attn.fused_attention.launches
    out = port_attn.fused_attention(q, k, v)
    assert port_attn.fused_attention.launches == before
    assert torch.equal(out, port_attn.attention_reference(q, k, v, 0.25))


def test_dispatch_raises_off_cpu_and_cuda():
    q = torch.empty((1, 1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        port_attn.fused_attention(q, q, q)
