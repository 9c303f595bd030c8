"""Which attention kernel a call launches (`attention_route`), what the
wrappers' `_check` refuses, and the plain train forward and backward against
the JAX package's dropout flash kernels in interpret mode at the shapes the
bf16 wgmma kernels serve: CLTR's three attentions at 2 batch rows and the
ViT's at (1, 2, 128, 128). The kernels themselves are held against these
plain versions on a card (test_torch_port_kernel_cuda.py)."""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet_torch_tpu.kernels import attention as A
from unet_torch_tpu_torch.kernels import attention as port_attn



@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the duration of each test of this file: the
    suite runs in several worker processes at once. The process's default
    comes back afterwards, for the tests that depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


WIDTHS = list(range(16, 129, 16))  # what `_check` takes
WGMMA = {(64, 64), (32, 32), (64, 32)}


@pytest.mark.parametrize("dqk,dv", list(itertools.product(WIDTHS, WIDTHS)))
def test_route_is_a_function_of_dtype_and_widths(dqk, dv):
    route = port_attn.attention_route(torch.bfloat16, dqk, dv)
    assert route == ("wgmma" if (dqk, dv) in WGMMA else "mma.sync")
    assert port_attn.attention_route(torch.float32, dqk, dv) == "f32"
    # the same answer every time, whatever was asked before
    assert port_attn.attention_route(torch.bfloat16, dqk, dv) == route
    # `_check` takes these widths in both dtypes
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(1, 1, 3, dqk, dtype=dtype)
        v = torch.zeros(1, 1, 2, dv, dtype=dtype)
        port_attn._check(q, torch.zeros(1, 1, 2, dqk, dtype=dtype), v, None)


def test_route_names_exactly_three_wgmma_instances():
    assert set(port_attn.WGMMA_WIDTHS) == WGMMA
    taken = {(a, b) for a, b in itertools.product(WIDTHS, WIDTHS)
             if port_attn.attention_route(torch.bfloat16, a, b) == "wgmma"}
    assert taken == WGMMA
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError):
            port_attn.attention_route(dtype, 64, 64)


def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(*shape, dtype=dtype, device=device)


@pytest.mark.parametrize("make,error,match", [
    (lambda: (_t(2, 8, 64), _t(1, 2, 8, 64), _t(1, 2, 8, 64), None),
     ValueError, "must be \\(B, H, N, D\\)"),
    (lambda: (_t(1, 2, 8, 64), _t(1, 2, 8, 32), _t(1, 2, 8, 64), None),
     ValueError, "k must be"),
    (lambda: (_t(1, 2, 8, 64), _t(1, 2, 8, 64), _t(1, 2, 4, 64), None),
     ValueError, "v must be"),
    (lambda: (_t(1, 2, 8, 8), _t(1, 2, 8, 8), _t(1, 2, 8, 16), None),
     ValueError, "multiples of 16"),
    (lambda: (_t(1, 2, 8, 24), _t(1, 2, 8, 24), _t(1, 2, 8, 16), None),
     ValueError, "multiples of 16"),
    (lambda: (_t(1, 2, 8, 64), _t(1, 2, 8, 64), _t(1, 2, 8, 144), None),
     ValueError, "multiples of 16"),
    (lambda: (_t(1, 2, 0, 64), _t(1, 2, 8, 64), _t(1, 2, 8, 64), None),
     ValueError, "empty input"),
    (lambda: (_t(1, 2, 8, 64, dtype=torch.float16),
              _t(1, 2, 8, 64, dtype=torch.float16),
              _t(1, 2, 8, 64, dtype=torch.float16), None),
     TypeError, "float32 or bfloat16"),
    (lambda: (_t(1, 2, 8, 64), _t(1, 2, 8, 64, dtype=torch.bfloat16),
              _t(1, 2, 8, 64), None), TypeError, "float32 or bfloat16"),
    (lambda: (_t(1, 2, 8, 64), _t(1, 2, 8, 64), _t(1, 2, 8, 64),
              _t(1, 7)), ValueError, "bias must be"),
    (lambda: (_t(1, 2, 8, 64), _t(1, 2, 8, 64), _t(1, 2, 8, 64),
              _t(1, 8, dtype=torch.bfloat16)), ValueError, "bias must be"),
    (lambda: (_t(1, 2, 64, 8).transpose(2, 3), _t(1, 2, 8, 64),
              _t(1, 2, 8, 64), None), ValueError, "contiguous"),
    (lambda: (_t(1, 2, 8, 64), _t(1, 2, 8, 64), _t(1, 2, 8, 64),
              _t(8, 2).t()[:1]), ValueError, "contiguous"),
    (lambda: (_t(1, 2, 8, 64), _t(1, 2, 8, 64),
              torch.zeros(1 * 2 * 8 * 64 + 1)[1:].view(1, 2, 8, 64), None),
     ValueError, "16-byte aligned"),
])
def test_check_rejects_what_it_rejected(make, error, match):
    with pytest.raises(error, match=match):
        port_attn._check(*make())


def test_check_names_a_tensor_on_another_device():
    q = _t(1, 2, 8, 64)
    with pytest.raises(ValueError, match="is on"):
        port_attn._check(q, q, q, None, extra=(("g", _t(1, device="meta")),))


def test_cuda_entry_points_refuse_other_devices():
    q = _t(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no attention kernel for device"):
        port_attn.attention_train_forward(q, q, q, 0.125)
    with pytest.raises(ValueError, match="no attention kernel for device"):
        port_attn.attention_backward(q, q, q, q, q, q, 0.125)
    with pytest.raises(ValueError, match="no attention kernel for device"):
        with torch.no_grad():
            port_attn.fused_attention(q, q, q)


# (B, H, Nq, Nk, Dqk, Dv) of the bf16 wgmma instances' callers: CLTR's
# encoder self-, decoder self- and decoder cross-attention at 2 batch rows,
# and the ViT's at one image of 128 tokens
WGMMA_SHAPES = [(2, 8, 64, 64, 32, 32), (2, 8, 2000, 2000, 32, 32),
                (2, 8, 2000, 64, 64, 32), (1, 2, 128, 128, 64, 64)]


@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_plain_versions_equal_dropout_flash_at_wgmma_shapes(shape):
    """At rate 0.1, in f32: the mask bit for bit `_dropout_keep`'s with the
    blocks and key stride of `_dfa_blocks`; (o, lse) within 1e-5 of
    `_dropout_flash_fwd` and (dq, dk, dv) within 1e-5 of
    `_dropout_flash_bwd1`, both in interpret mode (f32 sums in another
    order)."""
    b, h, nq, nk, dqk, dv = shape
    rate, seed, scale = 0.1, 1234, dqk ** -0.5
    rng = np.random.RandomState(6)
    q, k, v, g = (rng.randn(*s).astype(np.float32)
                  for s in ((b, h, nq, dqk), (b, h, nk, dqk), (b, h, nk, dv),
                            (b, h, nq, dv)))
    bq, bk = A._dfa_blocks(nq, nk)
    nk_p = A._ceil_to(nk, min(bk, A._ceil_to(nk, 128)))
    assert port_attn.dfa_nk_p(nk) == nk_p
    thr = port_attn.dropout_threshold(rate)

    for bh in (0, b * h - 1):
        ours = port_attn.dropout_keep(seed, b * h, nq, nk, nk_p, thr)[bh]
        ref = np.asarray(A._dropout_keep(jnp.uint32(seed), jnp.uint32(bh), 0,
                                         0, (nq, nk), nk_p, thr))
        np.testing.assert_array_equal(ours.numpy(), ref)

    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    ref_o, ref_lse = A._dropout_flash_fwd(jq, jk, jv, jnp.uint32(seed), scale,
                                          rate, block_q=bq, block_k=bk,
                                          interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = port_attn.attention_train_forward(tq, tk, tv, scale, None, seed,
                                               rate)
    assert o.shape == (b, h, nq, dv) and lse.shape == (b * h, nq)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :nq, 0],
                               atol=1e-5)

    nq_p = ref_lse.shape[1]
    dterm = jnp.einsum("bhqd,bhqd->bhq", jg, ref_o).reshape(b * h, nq)
    dterm = jnp.pad(dterm, ((0, 0), (0, nq_p - nq)))
    dterm = jnp.broadcast_to(dterm[..., None], dterm.shape + (8,))
    refs = A._dropout_flash_bwd1(jq, jk, jv, jnp.uint32(seed), ref_lse, dterm,
                                 jg, scale, rate, block_q=bq, block_k=bk,
                                 interpret=True)
    ours = port_attn.attention_backward(tq, tk, tv, o, lse, tg, scale, None,
                                        seed, rate)
    for name, a, r in zip("qkv", ours, refs):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=f"d{name}")
