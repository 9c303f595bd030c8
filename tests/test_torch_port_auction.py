"""The port's plain auction (kernels/auction.py::auction_lsap_reference, the
version the CUDA kernel is held equal to on the card) against the JAX
package's `auction_lsap` (jnp while-loop) and `auction_lsap_pallas`
(interpret mode), on the cases of tests/test_auction.py. Inputs are made from
a seed with numpy, in f32 for both sides.

Matches are compared for equality wherever the costs are tie-free: both
sides run the same rounds with the same f32 arithmetic and the same tie
rules. Total costs are held within T * eps of scipy's optimum (the
auction's guarantee), eps = 1e-4 * max |cost|."""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax
import jax.numpy as jnp

from unet_torch_tpu.kernels.auction import (
    auction_lsap as jax_auction_lsap,
    auction_lsap_batched as jax_auction_lsap_batched,
    auction_lsap_pallas,
)
from unet_torch_tpu_torch.kernels.auction import (
    auction_lsap,
    auction_lsap_batched,
    auction_lsap_reference,
)


def _port(costs, valid=None, **kw):
    costs = np.asarray(costs, np.float32)
    if valid is None:
        valid = np.ones((costs.shape[0], costs.shape[2]), bool)
    return auction_lsap(torch.from_numpy(costs), torch.from_numpy(valid),
                        **kw)


def _total_cost(cost, match, n):
    return sum(float(cost[match[j], j]) for j in range(n))


def _check_against_scipy(cost, match, n):
    """Feasible, and within T * eps of the optimum."""
    assert len(set(match[:n].tolist())) == n
    assert (match[n:] == 0).all()
    if n == 0:
        return
    rows, cols = linear_sum_assignment(cost[:, :n])
    opt = cost[rows, cols].sum()
    eps = 1e-4 * max(np.abs(cost[:, :n]).max(), 1e-6)
    # the f32 sums of up to n costs add a few ulps of the optimum
    assert _total_cost(cost, match, n) <= opt + n * eps + 1e-5 * abs(opt)


@pytest.mark.parametrize("q,t", [(20, 5), (50, 50), (200, 40), (64, 1)])
def test_reference_equals_jnp_path_and_scipy_cost(q, t):
    rng = np.random.RandomState(q * 100 + t)
    cost = (rng.rand(q, t) * 10).astype(np.float32)
    ours = _port(cost[None]).numpy()[0]
    theirs = np.asarray(jax_auction_lsap(jnp.asarray(cost),
                                         max_iters=20000))
    np.testing.assert_array_equal(ours, theirs)
    _check_against_scipy(cost, ours, t)


def test_padding_mask_equals_jnp_path():
    rng = np.random.RandomState(0)
    cost = (rng.rand(30, 8) * 5).astype(np.float32)
    valid = np.zeros(8, bool)
    valid[:3] = True
    ours = _port(cost[None], valid[None]).numpy()[0]
    theirs = np.asarray(jax_auction_lsap(jnp.asarray(cost),
                                         jnp.asarray(valid)))
    np.testing.assert_array_equal(ours, theirs)
    _check_against_scipy(cost, ours, 3)


def test_no_valid_target_returns_zeros_in_no_round():
    cost = np.random.RandomState(1).rand(1, 10, 4).astype(np.float32)
    match, rounds, bids = _port(cost, np.zeros((1, 4), bool), stats=True)
    assert (match.numpy() == 0).all()
    assert rounds.item() == 0 and bids.item() == 0


def test_cost_matrix_style_invalid_slots():
    """Costs as SetCriterion.cost_matrix makes them: 1e9 at invalid slots.
    The spread is taken over valid slots only, so eps stays small and the
    valid targets are still matched at the optimum."""
    rng = np.random.RandomState(5)
    cost = (rng.rand(3, 40, 8) * 4).astype(np.float32)
    valid = np.ones((3, 8), bool)
    valid[0, 5:] = False
    valid[2, :] = False
    cost = np.where(valid[:, None, :], cost, np.float32(1e9))
    ours = _port(cost, valid).numpy()
    theirs = np.asarray(jax.vmap(jax_auction_lsap)(jnp.asarray(cost),
                                                   jnp.asarray(valid)))
    np.testing.assert_array_equal(ours, theirs)
    for b in range(3):
        _check_against_scipy(cost[b], ours[b], int(valid[b].sum()))


def test_batched_equals_vmapped_jnp_path():
    rng = np.random.RandomState(2)
    costs = rng.rand(2, 3, 25, 6).astype(np.float32)
    valid = np.ones((2, 3, 6), bool)
    valid[1, :, 4:] = False
    ours = auction_lsap_batched(torch.from_numpy(costs),
                                torch.from_numpy(valid)).numpy()
    theirs = np.asarray(jax_auction_lsap_batched(
        jnp.asarray(costs), jnp.asarray(valid), use_pallas=False))
    assert ours.shape == (2, 3, 6) and ours.dtype == np.int32
    np.testing.assert_array_equal(ours, theirs)
    for l in range(2):
        for b in range(3):
            _check_against_scipy(costs[l, b], ours[l, b],
                                 int(valid[l, b].sum()))


def test_exhaustion_never_returns_negative_and_equals_jnp_path():
    """max_iters = 1: one round cannot assign 12 targets, so the greedy
    completion runs; it must leave a duplicate-free assignment, the same as
    the JAX package's."""
    rng = np.random.RandomState(3)
    q, t = 40, 12
    cost = (rng.rand(q, t) * 100).astype(np.float32)
    match, rounds, _ = _port(cost[None], max_iters=1, stats=True)
    match = match.numpy()[0]
    assert rounds.item() == 1
    assert (match >= 0).all() and (match < q).all()
    assert len(set(match.tolist())) == t
    theirs = np.asarray(jax_auction_lsap(jnp.asarray(cost), max_iters=1))
    np.testing.assert_array_equal(match, theirs)


@pytest.mark.parametrize("spread", [1e-6, 1.0, 1e8])
def test_adversarial_cost_spreads(spread):
    rng = np.random.RandomState(4)
    q, t = 60, 15
    cost = rng.rand(q, t) * spread
    cost[:, 0] = spread  # near-ties plus one dominant column
    cost[7, 0] = 0.0
    cost = cost.astype(np.float32)
    ours = _port(cost[None]).numpy()[0]
    theirs = np.asarray(jax_auction_lsap(jnp.asarray(cost),
                                         max_iters=20000))
    np.testing.assert_array_equal(ours, theirs)
    _check_against_scipy(cost, ours, t)


def test_reference_equals_pallas_interpret():
    """The whole-auction Pallas kernel in interpret mode, with padded rows,
    an instance without targets and ragged T and Q."""
    rng = np.random.RandomState(7)
    B, Q, T = 5, 200, 17
    costs = (rng.rand(B, Q, T) * 10).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[2, 9:] = False
    valid[4, :] = False
    ours = _port(costs, valid).numpy()
    theirs = np.asarray(auction_lsap_pallas(jnp.asarray(costs),
                                            jnp.asarray(valid),
                                            interpret=True))
    np.testing.assert_array_equal(ours, theirs)
    for b in range(B):
        _check_against_scipy(costs[b], ours[b], int(valid[b].sum()))


def test_instances_stop_at_their_own_round():
    """A batch runs each instance as if it were alone: the same matches,
    rounds and bids as one call per instance."""
    rng = np.random.RandomState(11)
    costs = (rng.rand(4, 150, 12) * 3).astype(np.float32)
    valid = np.ones((4, 12), bool)
    valid[1, 2:] = False
    match, rounds, bids = _port(costs, valid, stats=True)
    assert len(set(rounds.tolist())) > 1
    for b in range(4):
        m1, r1, b1 = _port(costs[b:b + 1], valid[b:b + 1], stats=True)
        np.testing.assert_array_equal(match[b].numpy(), m1[0].numpy())
        assert (rounds[b].item(), bids[b].item()) == (r1.item(), b1.item())


def test_q_equals_t_and_single_query():
    rng = np.random.RandomState(13)
    cost = (rng.rand(1, 9, 9) * 2).astype(np.float32)
    _check_against_scipy(cost[0], _port(cost).numpy()[0], 9)
    one = (rng.rand(1, 1, 1)).astype(np.float32)
    assert _port(one).numpy().tolist() == [[0]]


def test_wrapper_raises_on_bad_inputs():
    costs = torch.zeros(2, 5, 3)
    valid = torch.ones(2, 3, dtype=torch.bool)
    with pytest.raises(TypeError):
        auction_lsap(costs.double(), valid)
    with pytest.raises(ValueError):
        auction_lsap(costs, valid[:, :2])
    with pytest.raises(ValueError):
        auction_lsap(costs.to("meta"), valid.to("meta"))
    assert auction_lsap_reference(costs, valid).shape == (2, 3)


def test_reference_reports_bids_per_round():
    """`per_round` gets each round's bids by instance: they sum to `bids`,
    and an instance's rounds are those in which it bid."""
    rng = np.random.RandomState(17)
    costs = torch.from_numpy((rng.rand(3, 60, 20) * 5).astype(np.float32))
    valid = torch.ones(3, 20, dtype=torch.bool)
    valid[2] = False
    per_round = []
    match, rounds, bids = auction_lsap_reference(costs, valid, stats=True,
                                                 per_round=per_round)
    table = torch.stack(per_round)
    assert table.shape == (int(rounds.max()), 3)
    assert torch.equal(table.sum(dim=0), bids)
    assert torch.equal((table > 0).sum(dim=0, dtype=torch.int32), rounds)
    assert table[0].tolist() == [20, 20, 0]
    assert torch.equal(match, auction_lsap_reference(costs, valid))


def test_prepared_benefit_stays_float32_under_another_default_dtype():
    """The kernel reads the prepared benefit as f32 whatever the process's
    default dtype is."""
    from unet_torch_tpu_torch.kernels.auction import _prepare

    rng = np.random.RandomState(5)
    costs = torch.from_numpy((rng.rand(2, 7, 3) * 4).astype(np.float32))
    valid = torch.ones(2, 3, dtype=torch.bool)
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        benefit, eps = _prepare(costs, valid)
    finally:
        torch.set_default_dtype(before)
    assert benefit.dtype == torch.float32 and benefit.is_contiguous()
    assert torch.equal(benefit, -costs.transpose(1, 2))
    assert eps.dtype == torch.float32
