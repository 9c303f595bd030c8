"""The port's train-path attention (unet_torch_tpu_torch/kernels/attention.py:
the counter-hash dropout mask, the plain train forward and backward, the
autograd Function) against the JAX package's dropout flash kernels in
interpret mode on the CPU, at the tiny shapes tests/test_kernels.py uses.
The Hopper kernels themselves are held against these plain versions in
test_torch_port_kernel_cuda.py, on a card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_torch_tpu.kernels import attention as A
from unet_torch_tpu_torch.kernels import attention as port_attn


def _arrays(shape_q, shape_k, shape_v, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*s).astype(np.float32)
                 for s in (shape_q, shape_k, shape_v))


def _qkv(b, h, nq, nk, dqk, dv, seed=0):
    return _arrays((b, h, nq, dqk), (b, h, nk, dqk), (b, h, nk, dv), seed)


def _thr(rate):
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


@pytest.mark.parametrize("seed,n_bh,row0,nq,nk,nk_p,rate", [
    (0, 3, 0, 24, 40, 128, 0.3),
    (99, 2, 0, 40, 300, 384, 0.1),
    (2 ** 32 - 1, 4, 0, 17, 130, 512, 0.5),
    # row * nk_p passes 2**32 inside the tile: uint32 wraparound
    (7, 2, 2 ** 32 // 1024 - 5, 12, 1000, 1024, 0.25),
    (123456789, 1, 2 ** 32 // 4096 - 3, 9, 64, 4096, 0.75),
])
def test_dropout_keep_is_bit_exact(seed, n_bh, row0, nq, nk, nk_p, rate):
    thr = _thr(rate)
    ours = port_attn.dropout_keep(seed, n_bh, nq, nk, nk_p, thr, row0=row0)
    ref = np.stack([np.asarray(A._dropout_keep(
        jnp.uint32(seed), jnp.uint32(bh), row0, 0, (nq, nk), nk_p, thr))
        for bh in range(n_bh)])
    assert ours.dtype == torch.bool and ours.shape == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)
    # the probe's plain route is the same hash
    if row0 == 0:
        probe = port_attn.dropout_keep_mask(n_bh, nq, nk, seed, rate, "cpu",
                                            nk_p=nk_p)
        assert probe.dtype == torch.uint8
        np.testing.assert_array_equal(probe.numpy(), ref.astype(np.uint8))


@pytest.mark.parametrize("nq,nk", [(24, 40), (40, 300), (1024, 1024),
                                   (100, 77), (2000, 2000), (512, 1500)])
def test_dfa_nk_p_pads_as_jax(nq, nk):
    bq, bk = A._dfa_blocks(nq, nk)
    bk = min(bk, A._ceil_to(nk, 128))
    assert port_attn.dfa_nk_p(nk) == A._ceil_to(nk, bk)


def test_keep_fraction_and_threshold():
    keep = port_attn.dropout_keep(5, 8, 256, 256, 256, _thr(0.1))
    assert abs(keep.float().mean().item() - 0.9) < 0.005
    assert port_attn.dropout_threshold(0.0) == 0
    with pytest.raises(ValueError):
        port_attn.dropout_threshold(1.0)


@pytest.mark.parametrize("shape,rate", [((1, 2, 24, 40, 8, 8), 0.0),
                                        ((1, 1, 40, 300, 8, 8), 0.3),
                                        ((2, 2, 33, 70, 16, 8), 0.3)])
def test_train_forward_matches_dropout_flash(shape, rate):
    """The plain (o, lse) against `dropout_flash_attention` (interpret, the
    blocks of `_dfa_blocks`) and `_dropout_flash_fwd` with small explicit
    blocks, whose mask stride nk_p the port is given."""
    b, h, nq, nk, dqk, dv = shape
    q, k, v = _qkv(*shape, seed=1)
    scale, seed = dqk ** -0.5, 99
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = A.dropout_flash_attention(jq, jk, jv, jnp.uint32(seed), scale,
                                    rate, True)
    o, lse = port_attn.attention_train_reference(tq, tk, tv, scale,
                                                 seed=seed, rate=rate)
    assert o.shape == (b, h, nq, dv) and lse.shape == (b * h, nq)
    # the bound of tests/test_kernels.py: f32 sums in another order
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=1e-5)

    bq, bk = 16, 128
    ref_o, ref_lse = A._dropout_flash_fwd(jq, jk, jv, jnp.uint32(seed),
                                          scale, rate, block_q=bq,
                                          block_k=bk, interpret=True)
    o, lse = port_attn.attention_train_reference(
        tq, tk, tv, scale, seed=seed, rate=rate, nk_p=A._ceil_to(nk, bk))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :nq, 0],
                               atol=1e-5)


@pytest.mark.parametrize("shape,rate", [((1, 2, 130, 260, 32, 16), 0.25),
                                        ((2, 1, 70, 140, 16, 16), 0.0)])
def test_backward_matches_dropout_flash_bwd(shape, rate):
    """`attention_backward_reference` against the merged and the two-pass
    Pallas backward (interpret, explicit small blocks: several query and key
    tiles, padding on both) within the bound of
    test_dropout_flash_bwd_merged_matches_twopass."""
    b, h, nq, nk, dqk, dv = shape
    q, k, v = _qkv(*shape, seed=2)
    g = np.random.RandomState(3).randn(b, h, nq, dv).astype(np.float32)
    scale, seed = dqk ** -0.5, 9
    bq, bk = 64, 128
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = A._dropout_flash_fwd(jq, jk, jv, jnp.uint32(seed), scale, rate,
                                    block_q=bq, block_k=bk, interpret=True)
    nq_p = lse.shape[1]
    dterm = jnp.einsum("bhqd,bhqd->bhq", jg,
                       out[:, :nq].reshape(b, h, nq, dv)).reshape(b * h, nq)
    dterm = jnp.pad(dterm, ((0, 0), (0, nq_p - nq)))
    dterm = jnp.broadcast_to(dterm[..., None], dterm.shape + (8,))
    args = (jq, jk, jv, jnp.uint32(seed), lse, dterm, jg)
    refs = [A._dropout_flash_bwd1(*args, scale, rate, block_q=bq, block_k=bk,
                                  interpret=True),
            A._dropout_flash_bwd(*args, scale, rate, block_q=bq, block_k=bk,
                                 interpret=True)]

    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    nk_p = A._ceil_to(nk, bk)
    o, tlse = port_attn.attention_train_reference(tq, tk, tv, scale,
                                                  seed=seed, rate=rate,
                                                  nk_p=nk_p)
    ours = port_attn.attention_backward_reference(
        tq, tk, tv, o, tlse, tg, scale, seed=seed, rate=rate, nk_p=nk_p)
    for ref in refs:
        for name, a, r in zip("qkv", ours, ref):
            assert a.shape == r.shape, name
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5,
                                       err_msg=f"d{name}")


def _port_grads(fn, arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (fn(*ts) ** 2).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("shape,rate,seed", [((1, 2, 24, 40, 8, 8), 0.0, 7),
                                             ((1, 1, 40, 300, 8, 8), 0.3, 99),
                                             ((2, 2, 20, 36, 16, 8), 0.5, 3)])
def test_autograd_matches_jax_grad(shape, rate, seed):
    """The Function's CPU gradients against jax.grad through
    dropout_flash_attention (interpret), within the bound of
    test_dropout_fwd_bwd_vs_oracle_multitile."""
    q, k, v = _qkv(*shape, seed=4)
    scale = shape[4] ** -0.5

    def loss(q, k, v):
        return (A.dropout_flash_attention(q, k, v, jnp.uint32(seed), scale,
                                          rate, True) ** 2).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    before = (port_attn.attention_train_forward.launches,
              port_attn.attention_backward.launches)
    ours = _port_grads(lambda q, k, v: port_attn.dropout_flash_attention(
        q, k, v, seed, scale, rate), (q, k, v))
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a, np.asarray(r), atol=2e-4)
    # CPU tensors take the plain versions: no kernel launched
    assert (port_attn.attention_train_forward.launches,
            port_attn.attention_backward.launches) == before


@pytest.mark.parametrize("starts", [(60, 75), (60, 75, 0)])
def test_masked_gradients_match_attention_masked_diff(starts):
    """The differentiable `fused_attention` with a key-padding mask against
    `_attention_masked_diff` (interpret): the bias shift keeps the gradient
    of a row whose keys are all padding (starts 0) equal to the einsum
    backward's, whose probabilities there are uniform."""
    b, h, nq, nk, d = len(starts), 3, 70, 90, 32
    q, k, v = _qkv(b, h, nq, nk, d, d, seed=3)
    mask = np.zeros((b, nk), bool)
    for i, s in enumerate(starts):
        mask[i, s:] = True
    bias = jnp.asarray(np.where(mask, -1e30, 0.0).astype(np.float32))
    scale = d ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    out_ref = A._attention_masked_diff(*jargs, bias, scale, True, False)
    ref = jax.grad(lambda *a: jnp.sum(A._attention_masked_diff(
        *a, bias, scale, True, False) ** 2), (0, 1, 2))(*jargs)
    tmask = torch.from_numpy(mask)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = port_attn.fused_attention(*ts, key_padding_mask=tmask)
    assert out.grad_fn is not None
    # tests/test_kernels.py's masked bounds
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-4, atol=2e-5)
    (out ** 2).sum().backward()
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-4)


def test_fused_attention_without_grad_is_the_eval_path():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 16, 24, 16, 16))
    q.requires_grad_()
    with torch.no_grad():
        out = port_attn.fused_attention(q, k, v)
    assert out.grad_fn is None
    ref = port_attn.attention_reference(q.detach(), k, v, 16 ** -0.5)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    # with grad the same values, through the Function at rate 0
    out_g = port_attn.fused_attention(q, k, v)
    assert out_g.grad_fn is not None
    np.testing.assert_allclose(out_g.detach().numpy(), ref.numpy(), atol=1e-6)


def test_bf16_reference_rounds_like_the_kernel():
    """bf16 inputs: the plain train forward and backward return q's dtype
    and stay within bf16 rounding of the f32 computation."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 40, 50, 16, 16, 5))
    g = torch.randn(1, 2, 40, 16, generator=torch.Generator().manual_seed(0))
    o32, lse32 = port_attn.attention_train_reference(q, k, v, 0.25, seed=1,
                                                     rate=0.2)
    grads32 = port_attn.attention_backward_reference(q, k, v, o32, lse32, g,
                                                     0.25, seed=1, rate=0.2)
    b16 = [t.to(torch.bfloat16) for t in (q, k, v, g)]
    o, lse = port_attn.attention_train_reference(*b16[:3], 0.25, seed=1,
                                                 rate=0.2)
    grads = port_attn.attention_backward_reference(*b16[:3], o, lse, b16[3],
                                                   0.25, seed=1, rate=0.2)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    # inputs rounded to bf16 (2**-8 relative) move every result by a few
    # bf16 ulps of its peak
    for ours, ref in ((o, o32), *zip(grads, grads32)):
        assert ours.dtype == torch.bfloat16
        peak = ref.abs().max().item()
        assert (ours.float() - ref).abs().max().item() <= 2 ** -4 * peak
