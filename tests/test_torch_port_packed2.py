"""The port's packed two-head attention probe
(kernels/attention.py::packed2_attention) on CPU tensors, where it runs its
plain version, against the JAX probe it replaces,
benchmarks/r8_attn_ab.py::packed2_fwd, in Pallas interpret mode. Inputs are
made from a seed with numpy and handed to both sides.

f32: both sides take f32 scores and an f32 softmax and sum the second
product in f32, in other orders (the JAX probe divides by the row sum after
the product, the plain version before it): 1e-5 absolute. bf16: both round
the probabilities to bf16 once, at different points, and the output once,
so they differ by at most 2**-7 of max|v|, the flash kernels' bound."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet_torch_tpu_torch.kernels.attention import packed2_attention

_R8 = Path(__file__).resolve().parents[1] / "benchmarks" / "r8_attn_ab.py"


def _jax_probe():
    """benchmarks/r8_attn_ab.py, loaded by path (it defines functions and
    constants only when imported)."""
    spec = importlib.util.spec_from_file_location("r8_attn_ab", _R8)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.packed2_fwd


def _inputs(shape, seed):
    b, h, nq, nk, d = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, n, d).astype(np.float32) for n in (nq, nk, nk))


# (B, H, Nq, Nk, D)
@pytest.mark.parametrize("shape", [(1, 2, 64, 64, 64), (2, 4, 128, 128, 64)])
def test_packed_probe_f32_matches_jax_interpret(shape):
    q, k, v = _inputs(shape, sum(shape))
    scale = shape[-1] ** -0.5
    ours = packed2_attention(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    theirs = np.asarray(_jax_probe()(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), scale, interpret=True))
    assert ours.shape == theirs.shape == shape[:3] + (shape[4],)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)


def test_packed_probe_bf16_matches_jax_interpret():
    shape = (2, 4, 128, 128, 64)
    q, k, v = _inputs(shape, 3)
    scale = shape[-1] ** -0.5
    ours = packed2_attention(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), scale)
    theirs = _jax_probe()(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                          scale, interpret=True)
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    theirs = np.asarray(theirs.astype(jnp.float32))
    v_max = np.abs(np.asarray(jnp.asarray(v, jnp.bfloat16)
                              .astype(jnp.float32))).max()
    assert np.abs(ours - theirs).max() <= 2.0 ** -7 * v_max


def test_packed_probe_raises_on_what_it_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 2, 64, 64, 64), 0))
    with pytest.raises(ValueError):  # an odd number of heads
        packed2_attention(q[:, :1], k[:, :1], v[:, :1])
    with pytest.raises(ValueError):  # a head width other than 64
        packed2_attention(q[..., :32], k[..., :32], v[..., :32])
