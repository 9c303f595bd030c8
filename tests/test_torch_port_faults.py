"""Repairs of the port's differences from the JAX package (ROADMAP queue 3),
each against the JAX package's behaviour:

  * `core/dist.py::all_gather_dim` on `all_gather_into_tensor` and
    `reduce_scatter_tensor`: forward and backward bitwise equal to the
    zero-padded all-reduce formula it replaced, at dims 0-3 over 2 and 4
    gloo ranks, and `gradcheck` in f64 across the ranks; the exclusive
    prefix sum, now on the gather, bitwise its padded formula too;
  * `eval/metrics.py::class_argmax`: JAX's plane compares (a NaN at class
    0 keeps class 0, a NaN past it is passed over) up to 8 classes,
    `jnp.argmax` past 8, `torch.argmax` on finite logits;
  * `cli/train_cli.py::_delete_non_best`: a checkpoint that cannot be
    deleted is reported as the JAX CLI reports it, and the sweep still
    writes its results.csv.

The ranks are this file run as a script,

    python tests/test_torch_port_faults.py <rank> <world> <port> <out>

each reading `<out>/spec.pt` and writing `<out>/rank<rank>.pt`; they import
torch and the port alone.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_port_spatial import launch, run_rank

DIMS = [0, 1, 2, 3]
WORLDS = [2, 4]
SHAPE = (4, 6, 2, 8)


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _padded_gather(x, group, dim):
    """The zero-padded formula: every rank's x in its place of a zero
    tensor, summed over the ranks."""
    import torch.distributed as dist

    n, index = x.shape[dim], dist.get_rank(group)
    shape = list(x.shape)
    shape[dim] *= dist.get_world_size(group)
    full = x.new_zeros(shape)
    full.narrow(dim, index * n, n).copy_(x)
    dist.all_reduce(full, group=group)
    return full


def _padded_gather_grad(g, group, dim):
    """Its adjoint: the gradients summed over the ranks, the rank's share."""
    import torch.distributed as dist

    n = g.shape[dim] // dist.get_world_size(group)
    total = g.clone()
    dist.all_reduce(total, group=group)
    return total.narrow(dim, dist.get_rank(group) * n, n)


def _rounding_bound(g, group, dim):
    """What f32 rounding allows a sum of the ranks' gradients in any order:
    (world - 1) f32 epsilons of the sum of their magnitudes."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    return (world - 1) * torch.finfo(torch.float32).eps * _padded_gather_grad(
        g.abs().double(), group, dim)


def _whole(group, x, share, fn, out_shape, place):
    """The rank's `fn` of its `share` of the whole input x, put in its place
    of a zero `out_shape` tensor and summed over the ranks: one function of
    x on every rank, for gradcheck."""
    from unet_torch_tpu_torch.core.dist import (
        copy_to_group,
        reduce_from_group,
    )

    y = fn(share(copy_to_group(x, group)))
    full = x.new_zeros(out_shape)
    full[place] = y
    return reduce_from_group(full, group)


def _collectives(fn):
    """fn() with torch.distributed's all_reduce, all_gather_into_tensor and
    reduce_scatter_tensor recorded: [(name, elements of the tensor this
    rank hands the collective)]."""
    import torch.distributed as dist

    names = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")
    saved = {n: getattr(dist, n) for n in names}
    calls = []

    def recorded(name):
        def call(*args, **kwargs):
            calls.append((name, args[0 if name == "all_reduce" else 1]
                          .numel()))
            return saved[name](*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, recorded(n))
    try:
        fn()
    finally:
        for n in names:
            setattr(dist, n, saved[n])
    return calls


def _rank_case(spec):
    import torch.distributed as dist

    from unet_torch_tpu_torch.core.dist import (
        all_gather_dim,
        exclusive_prefix_sum,
    )
    from unet_torch_tpu_torch.core.mesh import make_mesh

    mesh = make_mesh(1, spec["world"], role="spatial")
    group, m, size = mesh.model_group, mesh.m, mesh.model
    gen = torch.Generator().manual_seed(100 + m)
    out = {"gather": {}, "gradcheck": {}}
    for dim in DIMS:
        x = torch.randn(SHAPE, generator=gen).requires_grad_()
        ours = all_gather_dim(x, group, dim)
        g = torch.randn(ours.shape, generator=gen)
        (dx,) = torch.autograd.grad(ours, x, g)
        exact = _padded_gather_grad(g.double(), group, dim)
        out["gather"][dim] = {
            "forward": torch.equal(ours.detach(),
                                   _padded_gather(x.detach(), group, dim)),
            "backward": torch.equal(dx, _padded_gather_grad(g, group, dim)),
            "backward_rounding": bool(((dx.double() - exact).abs()
                                       <= _rounding_bound(g, group, dim))
                                      .all()),
            "shape": tuple(ours.shape)}
        # gradcheck in f64 of one function of the whole input (the same on
        # every rank), each rank's share weighted by its rank so that the
        # ranks' gradients differ
        small = [2] * len(SHAPE)
        whole = torch.randn((*small[:dim], 2 * size, *small[dim + 1:]),
                            generator=torch.Generator().manual_seed(dim),
                            dtype=torch.float64)
        lo, n = 2 * m, 2

        def f(t, dim=dim, lo=lo, n=n):
            return _whole(group, t, lambda s: s.narrow(dim, lo, n),
                          lambda s: (m + 1) * all_gather_dim(s, group, dim),
                          (size,) + tuple(t.shape), m)

        w = whole.clone().requires_grad_()
        err = (f(w).detach().sum(0)
               - whole * size * (size + 1) / 2).abs().max().item()
        out["gradcheck"][dim] = (torch.autograd.gradcheck(f, (w,)), err)
    x = torch.randn(SHAPE, generator=gen).requires_grad_()
    box = {}
    out["calls"] = {
        "forward": _collectives(lambda: box.update(
            y=all_gather_dim(x, group, 1))),
        "backward": _collectives(lambda: box["y"].backward(
            torch.ones_like(box["y"])))}
    x = torch.randn(3, 5, generator=gen)
    full = torch.zeros((size, 3, 5))
    full[m] = x
    dist.all_reduce(full, group=group)
    out["prefix"] = torch.equal(exclusive_prefix_sum(x, group),
                                full[:m].sum(0))
    return out


# --------------------------------------------------------------------------
# the pytest side
# --------------------------------------------------------------------------

def _gather_ranks(tmp_path_factory, world):
    return launch(os.path.abspath(__file__),
                  {"mesh": (1, world), "world": world},
                  str(tmp_path_factory.mktemp(f"gather{world}")))


# one launch a world, so that a rank's fault errors its own world's cases
@pytest.fixture(scope="module")
def gathers_2(tmp_path_factory):
    return _gather_ranks(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def gathers_4(tmp_path_factory):
    return _gather_ranks(tmp_path_factory, 4)


@pytest.fixture
def gathers(request, world):
    """{world: the ranks' results} of the case's world."""
    return {world: request.getfixturevalue(f"gathers_{world}")}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_dim_is_the_zero_padded_formula_bitwise(gathers, world,
                                                           dim):
    """The all-gather's output equals, bit for bit, the zero-padded
    all-reduce's (a sum with zeros is exact). So does the reduce-scatter's
    gradient over two ranks (a sum of two terms is the same in either
    order); over four its sums of the ranks' gradients may run in another
    order than the all-reduce's, within their f32 rounding."""
    for r in gathers[world]:
        res = r["gather"][dim]
        want = list(SHAPE)
        want[dim] *= world
        assert res["shape"] == tuple(want)
        assert res["forward"] and res["backward_rounding"], res
        if world == 2:
            assert res["backward"], res


@pytest.mark.timeout(300)
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_dim_passes_gradcheck_across_ranks(gathers, world, dim):
    for r in gathers[world]:
        passed, err = r["gradcheck"][dim]
        assert passed and err <= 1e-12, (passed, err)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_dim_hands_the_collectives_a_rank_s_share(gathers,
                                                             world):
    """The forward is one all-gather of the rank's share, the backward one
    reduce-scatter of the whole gradient: no all-reduce of a zero-padded
    tensor, whose every rank hands over M times its share."""
    share = int(np.prod(SHAPE))
    for r in gathers[world]:
        assert r["calls"] == {
            "forward": [("all_gather_into_tensor", share)],
            "backward": [("reduce_scatter_tensor", world * share)]}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("world", WORLDS)
def test_exclusive_prefix_sum_on_the_gather_is_the_padded_formula(gathers,
                                                                  world):
    assert all(r["prefix"] for r in gathers[world])


def _nan_logits(c, seed):
    """(4, 16, 16, c) logits with NaNs at a fifth of the entries, ties of
    equal integers, infinities, and whole rows of NaN."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-3, 4, (4, 16, 16, c)).astype(np.float32)
    x[rng.rand(*x.shape) < 0.2] = np.nan
    x[rng.rand(*x.shape) < 0.05] = np.inf
    x[rng.rand(*x.shape) < 0.05] = -np.inf
    x[0, 0] = np.nan
    return x


@pytest.mark.parametrize("c", [2, 3, 8])
def test_class_argmax_takes_jax_s_nan_rule(c):
    """Up to 8 classes, JAX's plane compares: a NaN at class 0 keeps class
    0 (nothing compares greater than it), a NaN past class 0 is passed
    over; the first maximum wins."""
    from unet_torch_tpu.eval.metrics import class_argmax as jax_argmax
    from unet_torch_tpu_torch.eval.metrics import class_argmax

    x = _nan_logits(c, c)
    ours = class_argmax(torch.from_numpy(x))
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_argmax(x)))
    if c == 3:
        rows = np.array([[np.nan, 1, 2], [0, np.nan, 2], [0, 1, np.nan],
                         [3, np.nan, 1]], np.float32)
        np.testing.assert_array_equal(
            class_argmax(torch.from_numpy(rows)).numpy(), [0, 2, 1, 0])


def test_class_argmax_past_eight_classes_is_argmax():
    """Past 8 classes the JAX package calls jnp.argmax, which takes a NaN as
    the maximum; so does the port."""
    import jax.numpy as jnp

    from unet_torch_tpu.eval.metrics import class_argmax as jax_argmax
    from unet_torch_tpu_torch.eval.metrics import class_argmax

    x = _nan_logits(9, 9)
    want = np.asarray(jnp.argmax(x, axis=-1))
    np.testing.assert_array_equal(np.asarray(jax_argmax(x)), want)
    np.testing.assert_array_equal(class_argmax(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("c", [2, 3, 8, 9])
def test_class_argmax_on_finite_logits_is_torch_argmax(c):
    from unet_torch_tpu_torch.eval.metrics import class_argmax

    rng = np.random.RandomState(c)
    x = torch.from_numpy(rng.randn(4, 16, 16, c).astype(np.float32))
    ties = torch.from_numpy(rng.randint(-2, 3, (4, 16, 16, c))
                            .astype(np.float32))
    for t in (x, ties):
        assert torch.equal(class_argmax(t),
                           torch.argmax(t, dim=-1).to(torch.uint8))


@pytest.mark.timeout(300)
def test_a_checkpoint_that_cannot_be_deleted_leaves_the_sweep_going(
        tmp_path, monkeypatch, capsys):
    """os.remove raising for one epoch checkpoint: the message is the JAX
    CLI's, the file stays, the others go, and results.csv is written."""
    from unet_torch_tpu_torch.cli import train_cli
    from unet_torch_tpu_torch.cli.config import Config
    from unet_torch_tpu_torch.data.synthetic import write_synthetic_dataset

    from test_torch_port_train_e2e import _cfg

    root = tmp_path / "data"
    for split, seed in (("train", 1), ("val", 2), ("test", 3)):
        write_synthetic_dataset(str(root / split), n_images=3, size=64,
                                n_classes=3, seed=seed)
    save_dir = tmp_path / "run"
    remove, refused = os.remove, []

    def remove_but_one(path, *args, **kwargs):
        if "epoch" in os.path.basename(path) and not refused:
            refused.append(path)
            raise PermissionError(13, "Permission denied", path)
        return remove(path, *args, **kwargs)

    monkeypatch.setattr(os, "remove", remove_but_one)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _, results = train_cli.run_training(
            Config.from_dict(_cfg(root, save_dir, "single")), device="cpu")
    finally:
        torch.set_num_threads(n)
    assert refused and results[7]
    (path,) = refused
    assert f"Error deleting {path}: " in capsys.readouterr().out
    assert os.path.exists(path)
    models = save_dir / "run_seed7" / "models"
    left = sorted(p.name for p in models.iterdir())
    assert left == sorted({"best.pt", "last_epoch.pt",
                           os.path.basename(path)})
    assert (save_dir / "results.csv").exists()


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
             sys.argv[4], _rank_case)
