"""Auction linear sum assignment: the Hopper kernel and its plain PyTorch
version (DETR matching on the device).

The JAX package's whole-auction Pallas kernel
(unet_torch_tpu/kernels/auction.py::_auction_pallas, with the
`_greedy_complete` pass after it) is ported as a hand-written CUDA kernel,
csrc/auction_lsap.cu: Bertsekas' forward auction with Jacobi bidding, one
cold-started phase at eps = spread * 1e-4, each instance run to its own
convergence, then greedy completion of whatever `max_iters` left unassigned.
The assignment's cost is within T * eps of the optimum. One block runs one
instance; the long tail of rounds with a single bidder runs on one warp
without block barriers, taking the bidder's best two queries from a cache
of candidates in shared memory that stays exact while prices rise, where
the cache fits (the source says how).

    costs (B, Q, T) f32, valid (B, T) bool  ->  match (B, T) int32

`match[b, t]` is the query (row) of target (column) t, 0 at padded slots.
`auction_lsap` routes by the device of `costs`: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel, which raises on anything it does
not take. `auction_lsap.launches` counts the kernel's launches. Kernel and
plain version run the same rounds in the same f32 order, so their matches,
round counts and bid counts are equal, not close. There is no gradient: both
run under `no_grad` on detached costs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from unet_torch_tpu_torch.kernels import build

_NEG = -1e30
# 16 bytes a query and a target, and the block's scratch, in a block's
# 227 KB of shared memory (csrc/auction_lsap.cu::smem_bytes)
_MAX_SMEM = 232448
_SCRATCH_BYTES = 256


def _prepare(costs, valid):
    """(benefit (B, T, Q) f32 contiguous, eps (B,) f32): the negated,
    transposed costs, and 1e-4 of the largest |cost| over valid slots (at
    least 1e-6). The rows of padded targets are kept as they are: a padded
    target never bids, so no value of its row is ever used."""
    if costs.dim() != 3 or tuple(valid.shape) != (costs.shape[0],
                                                  costs.shape[2]):
        raise ValueError(f"costs must be (B, Q, T) and valid (B, T), got "
                         f"{tuple(costs.shape)} and {tuple(valid.shape)}")
    if costs.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"costs must be float32 and valid bool, got "
                        f"{costs.dtype} and {valid.dtype}")
    if valid.device != costs.device:
        raise ValueError(f"valid is on {valid.device}, costs on "
                         f"{costs.device}")
    if min(costs.shape) == 0:
        raise ValueError(f"empty costs {tuple(costs.shape)}")
    # one transposing pass (an elementwise op on the transposed view would
    # keep its layout and need a copy after it); max |cost| is exact
    costs = costs.detach()
    b, q_n, t_n = costs.shape
    benefit = torch.empty((b, t_n, q_n), dtype=costs.dtype,
                          device=costs.device)
    torch.neg(costs.transpose(1, 2), out=benefit)
    spread = torch.linalg.vector_norm(
        costs.masked_fill(~valid[:, None, :], 0.0), ord=float("inf"),
        dim=(1, 2))
    eps = spread.clamp(min=1e-6) * 1e-4
    return benefit, eps


def _greedy_complete(benefit, valid, match):
    """Leftover valid targets, in order, take their best-benefit query that
    no target owns."""
    b, t_n, q_n = benefit.shape
    unmatched = (match < 0) & valid
    if not bool(unmatched.any()):
        return match
    owned = torch.zeros((b, q_n + 1), dtype=torch.bool, device=match.device)
    owned.scatter_(1, torch.where(match >= 0, match, q_n),
                   torch.ones_like(match, dtype=torch.bool))
    owned = owned[:, :q_n].clone()
    rows = torch.arange(b, device=match.device)
    match = match.clone()
    for t in range(t_n):
        need = unmatched[:, t]
        q = torch.where(owned, _NEG, benefit[:, t]).argmax(dim=1)
        owned[rows, q] |= need
        match[:, t] = torch.where(need, q, match[:, t])
    return match


@torch.no_grad()
def auction_lsap_reference(costs, valid, max_iters: int = 20000,
                           stats: bool = False, per_round=None):
    """Plain version: the rounds as batched tensor ops. An instance with no
    unassigned valid target makes no bid, so it stays as it is while the
    others go on; `rounds` and `bids` count only the rounds it bid in. A
    list given as `per_round` receives each round's bids by instance, (B,)
    int32."""
    benefit, eps = _prepare(costs, valid)
    b, t_n, q_n = benefit.shape
    dev = benefit.device
    t_ids = torch.arange(t_n, device=dev).expand(b, t_n)
    price = torch.zeros((b, q_n), device=dev)
    owner = torch.full((b, q_n), t_n, dtype=torch.long, device=dev)
    match = torch.full((b, t_n), -1, dtype=torch.long, device=dev)
    rounds = torch.zeros(b, dtype=torch.int32, device=dev)
    bids = torch.zeros(b, dtype=torch.int32, device=dev)
    neg = torch.tensor(_NEG, device=dev)
    for _ in range(max_iters):
        unassigned = (match < 0) & valid
        if not bool(unassigned.any()):
            break
        values = benefit - price[:, None, :]
        v1, i1 = values.max(dim=2)
        v2 = values.scatter_(2, i1[..., None], _NEG).amax(dim=2)
        bid = price.gather(1, i1) + (v1 - v2) + eps[:, None]
        bid = torch.where(unassigned, bid, neg)
        # the highest bid per query wins; ties go to the lowest target
        best_bid = torch.full((b, q_n), _NEG, device=dev).scatter_reduce_(
            1, i1, bid, "amax")
        contender = unassigned & (bid >= best_bid.gather(1, i1)) & (bid > neg)
        winner = torch.full((b, q_n), t_n, dtype=torch.long,
                            device=dev).scatter_reduce_(
            1, i1, torch.where(contender, t_ids, t_n), "amin")
        won = contender & (winner.gather(1, i1) == t_ids)
        has_winner = winner < t_n
        price = torch.where(has_winner, torch.maximum(best_bid, price), price)
        owner = torch.where(has_winner, winner, owner)
        match = torch.where(won, i1, match)
        # a target whose query was taken becomes unassigned
        still = (match >= 0) & (owner.gather(1, match.clamp(min=0)) == t_ids)
        match = torch.where(still, match, -1)
        n_bids = unassigned.sum(dim=1, dtype=torch.int32)
        if per_round is not None:
            per_round.append(n_bids)
        rounds += n_bids > 0
        bids += n_bids
    match = _greedy_complete(benefit, valid, match)
    match = torch.where(valid, match, 0).to(torch.int32)
    return (match, rounds, bids) if stats else match


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("auction_lsap")
    lib.auction_lsap.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p])
    lib.auction_lsap.restype = ctypes.c_int
    lib.auction_lsap_error_string.argtypes = [ctypes.c_int]
    lib.auction_lsap_error_string.restype = ctypes.c_char_p
    return lib


def _launch(benefit, valid, eps, max_iters):
    """One launch of the kernel on `_prepare`'s (benefit, eps) and the u8 or
    bool valid (B, T) on the current stream: (match, rounds, bids) int32."""
    b, t_n, q_n = benefit.shape
    if 16 * (q_n + t_n) + _SCRATCH_BYTES > _MAX_SMEM:
        raise ValueError(f"Q = {q_n}, T = {t_n}: 16 bytes a query and a "
                         "target do not fit a block's shared memory")
    valid = valid.contiguous()
    dev = benefit.device
    match = torch.empty((b, t_n), dtype=torch.int32, device=dev)
    rounds = torch.empty(b, dtype=torch.int32, device=dev)
    bids = torch.empty(b, dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.auction_lsap(benefit.data_ptr(), valid.data_ptr(),
                               eps.data_ptr(), match.data_ptr(),
                               rounds.data_ptr(), bids.data_ptr(), b, t_n,
                               q_n, int(max_iters), stream)
    if err:
        msg = lib.auction_lsap_error_string(err).decode()
        raise RuntimeError(f"auction_lsap launch failed: {msg}")
    auction_lsap.launches += 1
    return match, rounds, bids


@torch.no_grad()
def auction_lsap(costs, valid, max_iters: int = 20000, stats: bool = False):
    """Min-cost assignment of targets (columns) to queries (rows), batched:
    costs (B, Q, T) f32, valid (B, T) bool -> match (B, T) int32; with
    `stats` also (rounds (B,), bids (B,)) int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the Hopper
    kernel once for all instances on the current stream, without
    synchronising, or raises."""
    if costs.device.type == "cpu":
        return auction_lsap_reference(costs, valid, max_iters, stats)
    if costs.device.type != "cuda":
        raise ValueError(f"no auction for device {costs.device}")
    benefit, eps = _prepare(costs, valid)
    match, rounds, bids = _launch(benefit, valid, eps, max_iters)
    return (match, rounds, bids) if stats else match


auction_lsap.launches = 0


def auction_lsap_batched(costs, valid, max_iters: int = 20000):
    """costs (..., Q, T), valid (..., T) -> match (..., T): every leading
    dimension is one batch of instances, one launch."""
    flat_c = costs.reshape((-1,) + costs.shape[-2:])
    flat_v = valid.reshape((-1,) + valid.shape[-1:])
    return auction_lsap(flat_c, flat_v, max_iters).reshape(valid.shape)
