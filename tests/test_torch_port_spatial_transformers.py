"""Spatial (height) partitioning of the TransUnet and CLTR families
(parallel/spatial.py, nn/strips.py, the strip layers of models/transunet/
and models/cltr/, core/dist.py's gather and prefix sum, the attention
mask's query-row offset) on the CPU over gloo, against the JAX package's
forward and steps on `shard_spatial` and against the port's own
one-process step.

The ranks are this file run as a script,

    python tests/test_torch_port_spatial_transformers.py <rank> <world> <port> <out>

each reading `<out>/spec.pt` and writing `<out>/rank<rank>.pt`; they import
torch and the port alone. The JAX side runs in pytest, on
`make_mesh(2, 2)` of the virtual CPU devices (XLA's partitioning changes no
value but by the order of its sums, so one sharded forward is the
reference of every mesh). Models: the small hybrid TransUnet of
tests/test_torch_port_parallel.py (ViT width 64, 4 heads, 2 layers, R50 of
one unit a block) at 64x64, whose pooled map of 15 rows splits 4/4/4/3 at
M = 4 with one token row a rank; CLTR as `CLTR` there (16 queries, hidden
32, 4 heads, 1 + 2 layers, ResNet-50 of one unit a layer) at 128x128, a
4x4 feature map:

  * (D, M) = (1, 2), (1, 4) and (2, 2): the TransUnet eval forward,
    gathered, against JAX's; at (1, 2) the two-head TransUnet against the
    port's one-process forward; at (1, 2) and (1, 4) CLTR's outputs;
  * (2, 2): one SGD step of the TransUnet (`dice_bce_mc`, DDP and the Dice
    sums over the world group) against `make_single_steps` on the
    spatially sharded batch, and with dropout and attention dropout 0.1
    against the port's one-process step; one SGD step of CLTR (DDP over
    the world group, the point count over the data group, the auction on
    the replicated outputs) against `make_cltr_fused_step`, with the same
    matches, and with dropout 0.1 against the port's one-process step;
  * on every mesh, by `torch.autograd.gradcheck` in f64 across the ranks:
    the uneven halo exchange, the differentiable gather, the exclusive
    prefix sum, the strip GroupNorm over uneven strips and the strip
    align-corners upsample, each also against its whole-image value.

On every mesh also the strips' sine embeddings of a padding mask against
the whole's, bit for bit, and the strip upsample against the JAX model's
interpolation matrices. In pytest alone: the mask of a query-row offset
against the slice of the whole mask, bit for bit; a strip's plain train
attention against the whole's rows; the heights each family refuses.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_port_spatial import launch

IMG_VIT, IMG_CLTR = 64, 128
LR, WD = 0.1, 1e-4
TOL_EVAL = dict(atol=2e-4, rtol=1e-3)
TOL_STEP = dict(atol=1e-4, rtol=1e-3)
GN_EPS = 1e-6


def build_transunet(kind, dropout=0.0):
    from unet_torch_tpu_torch.models.transunet.configs import CONFIGS
    from unet_torch_tpu_torch.models.transunet.vit import (
        VisionTransformer,
        VisionTransformerMultitask,
    )

    from test_torch_port_parallel import vit_config

    cls = (VisionTransformerMultitask if kind == "multitask"
           else VisionTransformer)
    return cls(vit_config(CONFIGS, dropout), IMG_VIT, 3)


def build_cltr(dropout=0.0):
    from unet_torch_tpu_torch.models import cltr as pc

    from test_torch_port_parallel import CLTR

    return pc.ConditionalDETR(**{**CLTR, "dropout_rate": dropout})


def cltr_criterion():
    from unet_torch_tpu_torch.models import cltr as pc

    from test_torch_port_parallel import CLTR

    return pc.SetCriterion(num_classes=2, weight_dict=pc.build_weight_dict(
        dec_layers=CLTR["dec_layers"]))


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _whole(mesh, x, share, fn, out_shape, place):
    """The rank's `fn` of its `share` of the whole input x (the gradient of
    x summed over the ranks), put in its place of a zero `out_shape`
    tensor and summed over the ranks: one function of x for gradcheck."""
    from unet_torch_tpu_torch.core.dist import (
        copy_to_group,
        reduce_from_group,
    )

    group = mesh.world_group
    y = fn(share(copy_to_group(x, group)))
    full = x.new_zeros(out_shape)
    full[place] = y
    return reduce_from_group(full, group)


def _gradchecks(mesh):
    """{name: (gradcheck passed, largest error of the forward against the
    whole image's)} of each strip collective and layer, in f64."""
    import torch.nn.functional as F

    from unet_torch_tpu_torch.core.dist import (
        all_gather_dim,
        exchange_rows,
        exclusive_prefix_sum,
    )
    from unet_torch_tpu_torch.models.cltr.position_encoding import (
        sine_position_embedding,
    )
    from unet_torch_tpu_torch.nn.strips import (
        strip_group_norm,
        upsample_rows_2x,
    )

    group, d, m, n_m = mesh.model_group, mesh.d, mesh.m, mesh.model
    gen = torch.Generator().manual_seed(3)
    rows = slice(d, d + 1)
    out = {}

    def check(name, x, share, fn, out_shape, place, want):
        def f(t):
            return _whole(mesh, t, share, fn, out_shape, place)

        x = x.requires_grad_()
        y = f(x).detach()
        err = (y - want(x.detach())).abs().max().item()
        out[name] = (torch.autograd.gradcheck(f, (x,)), err)
        return y

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    # the uneven halo of a 7x7/2 conv (3 rows above, 2 below) and of the
    # VALID pool (0, 1), around strips of 4 rows
    for above, below in ((3, 2), (0, 1)):
        n = 4 + above + below
        x = rand(mesh.data, 2, 4 * n_m, 3)
        padded = F.pad(x, (0, 0, above, below))
        check(f"exchange_rows_{above}_{below}", x,
              lambda t: t[rows, :, 4 * m:4 * m + 4],
              lambda s, a=above, b=below: exchange_rows(s, group, above=a,
                                                        below=b),
              (mesh.data, 2, n * n_m, 3),
              (rows, slice(None), slice(n * m, n * m + n)),
              lambda t, p=padded, n=n: torch.cat(
                  [p[:, :, 4 * j:4 * j + n] for j in range(n_m)], 2))
    # the gather of every strip's tokens, weighted by the rank so that the
    # ranks' gradients differ
    x = rand(mesh.data, 3, 2 * n_m, 2)
    check("all_gather_dim", x, lambda t: t[rows, :, 2 * m:2 * m + 2],
          lambda s: (m + 1) * all_gather_dim(s, group, 2), x.shape,
          (rows,), lambda t: t * n_m * (n_m + 1) / 2)
    x = rand(mesh.data, n_m, 3)
    check("exclusive_prefix_sum", x, lambda t: t[rows, m],
          lambda s: exclusive_prefix_sum(s, group), x.shape, (rows, m),
          lambda t: t.cumsum(1) - t)
    # GroupNorm over strips of 4, 4, ..., 3 rows (the pooled map's split)
    h = 4 * n_m - 1
    sl = slice(4 * m, min(4 * m + 4, h))
    x = rand(mesh.data, 4, h, 3)
    weight, bias = rand(4) + 1, rand(4)
    check("strip_group_norm", x, lambda t: t[rows, :, sl],
          lambda s: strip_group_norm(s, 2, weight, bias, GN_EPS, group),
          x.shape, (rows, slice(None), sl),
          lambda t: F.group_norm(t, 2, weight, bias, GN_EPS))
    # the align-corners 2x upsample of NHWC strips of 2 rows
    x = rand(mesh.data, 2 * n_m, 3, 2)
    y = check("upsample_rows_2x", x, lambda t: t[rows, 2 * m:2 * m + 2],
              lambda s: upsample_rows_2x(s, group, m, n_m),
              (mesh.data, 4 * n_m, 6, 2), (rows, slice(4 * m, 4 * m + 4)),
              lambda t: F.interpolate(t.permute(0, 3, 1, 2), scale_factor=2,
                                      mode="bilinear", align_corners=True)
              .permute(0, 2, 3, 1))
    out["upsample"] = (x.detach(), y)
    # the sine embedding of a padding mask's strips of 2 feature rows
    mask = torch.rand((2, 2 * n_m, 5), generator=gen) < 0.3
    strip = slice(2 * m, 2 * m + 2)
    out["sine"] = torch.equal(
        sine_position_embedding(mask[:, strip], 16, group=group),
        sine_position_embedding(mask, 16)[:, strip])
    return out


def _eval(spec, mesh):
    from unet_torch_tpu_torch.parallel.spatial import (
        gather_spatial,
        shard_spatial,
        spatialize,
    )

    result = {}
    for name, (kind, state) in spec["eval"].items():
        model = build_cltr() if kind == "cltr" else build_transunet(kind)
        model.load_state_dict(state, strict=True)
        spatialize(model, mesh).eval()
        (x,) = shard_spatial(mesh, [spec["xc" if kind == "cltr" else "x"]],
                             "cpu")
        with torch.no_grad():
            out = model(x)
        if kind == "cltr":
            result[name] = {k: out[k] for k in ("pred_logits",
                                                "pred_points")}
        else:
            out = out if isinstance(out, tuple) else (out,)
            result[name] = tuple(gather_spatial(o, mesh) for o in out)
    return result


def _transunet_step(spec, dropout, mesh):
    from torch.nn.parallel import DistributedDataParallel

    from unet_torch_tpu_torch.parallel.spatial import (
        shard_spatial,
        spatialize,
    )
    from unet_torch_tpu_torch.train.optim import make_optimizer
    from unet_torch_tpu_torch.train.steps import make_single_steps

    model = build_transunet("single", dropout)
    model.load_state_dict(spec["state"], strict=True)
    spatialize(model, mesh)
    net = DistributedDataParallel(model, process_group=mesh.world_group,
                                  broadcast_buffers=False)
    x, y = shard_spatial(mesh, [spec["x"], spec["y"]], "cpu")
    opt = make_optimizer("SGD", model.parameters(), LR, WD)
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", 3,
                                group=mesh.world_group)
    loss = step(net, opt, x, y, LR, torch.Generator().manual_seed(5))
    return {"loss": float(loss), "state": model.state_dict(),
            "buffers": {k: v.clone() for k, v in model.named_buffers()}}


def _cltr_step(spec, dropout, mesh):
    """The CLTR step on the rank's rows and strip: DDP over the world
    group, the criterion's point count over the data group; returns the
    loss, the state and the step's matches."""
    from torch.nn.parallel import DistributedDataParallel

    from unet_torch_tpu_torch.parallel.spatial import (
        shard_spatial,
        spatialize,
    )
    from unet_torch_tpu_torch.train import cltr_steps
    from unet_torch_tpu_torch.train.optim import make_optimizer

    model = build_cltr(dropout)
    model.load_state_dict(spec["state"], strict=True)
    spatialize(model, mesh)
    net = DistributedDataParallel(model, process_group=mesh.world_group,
                                  broadcast_buffers=False)
    (x,) = shard_spatial(mesh, [spec["x"]], "cpu")
    rows = mesh.rows(len(spec["x"]))
    targets = [torch.from_numpy(spec[k][rows])
               for k in ("labels", "points", "valid")]
    opt = make_optimizer("SGD", model.parameters(), LR, WD)
    matches = []
    match_targets = cltr_steps.match_targets

    def recorded(*args, **kw):
        matches.append(match_targets(*args, **kw))
        return matches[-1]

    cltr_steps.match_targets = recorded
    try:
        loss, _ = cltr_steps.train_step(
            net, cltr_criterion(), opt, x, *targets, LR,
            torch.Generator().manual_seed(5),
            torch.Generator().manual_seed(6), "auction", mesh.data_group)
    finally:
        cltr_steps.match_targets = match_targets
    return {"loss": float(loss), "state": model.state_dict(),
            "match": matches[0]}


def _rank_case(spec):
    from unet_torch_tpu_torch.core.mesh import make_mesh

    mesh = make_mesh(*spec["mesh"], role="spatial")
    result = {"rank": mesh.rank, "gradcheck": _gradchecks(mesh),
              "eval": _eval(spec, mesh)}
    if "transunet_step" in spec:
        s = spec["transunet_step"]
        result["transunet"] = {name: _transunet_step(s, p, mesh)
                               for name, p in (("plain", 0.0),
                                               ("dropout", s["dropout"]))}
        s = spec["cltr_step"]
        result["cltr"] = {name: _cltr_step(s, p, mesh)
                          for name, p in (("plain", 0.0),
                                          ("dropout", s["dropout"]))}
    return result


def _rank_main(rank, world, port, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from unet_torch_tpu_torch.core.dist import maybe_initialize

    maybe_initialize(force=True, backend="gloo")
    spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
    torch.save(_rank_case(spec), os.path.join(out, f"rank{rank}.pt"))


# --------------------------------------------------------------------------
# the pytest side
# --------------------------------------------------------------------------

def _jax_cltr(rng):
    """JAX's CLTR on make_mesh(2, 2): (spec of the step, the eval outputs,
    the SGD step's loss and state, the matches its forward's costs give)."""
    import jax
    import jax.numpy as jnp

    from unet_torch_tpu.core.mesh import make_mesh, replicated_sharding
    from unet_torch_tpu.kernels.auction import auction_lsap_batched
    from unet_torch_tpu.models import cltr as jc
    from unet_torch_tpu.parallel.spatial import shard_spatial
    from unet_torch_tpu.train.cltr_steps import (
        make_cltr_fused_step,
        make_cltr_steps,
    )
    from unet_torch_tpu.train.optim import make_optimizer
    from unet_torch_tpu.train.state import TrainState
    from unet_torch_tpu_torch.ckpt.bridge import cltr_state_dict_from_flax
    from unet_torch_tpu_torch.models import cltr as pc

    from test_torch_port_parallel import CLTR

    smesh = make_mesh(2, 2, devices=jax.devices()[:4])
    model = jc.ConditionalDETR(**CLTR)
    x = rng.randn(4, IMG_CLTR, IMG_CLTR, 3).astype(np.float32)
    variables = jax.tree_util.tree_map(np.array, model.init(
        jax.random.key(0), jnp.asarray(x[:1]), train=False))
    pe = variables["params"]["point_embed"]["layer2"]
    pe["kernel"] = (rng.randn(*pe["kernel"].shape) * 0.1).astype(np.float32)
    # five points an image, no padded slot: JAX's losses scatter the padded
    # slots onto query 0, where they overwrite a valid target's class
    # (ROADMAP queue 3, tests/test_torch_port_cltr.py
    # test_level_losses_query_zero_repair), which the port does not copy
    targets = []
    for _ in range(4):
        pts = rng.rand(5, 3).astype(np.float32)
        targets.append({"labels": np.ones(5, np.int64), "points": pts,
                        "points_macher": pts})
    labels, points, _, valid = pc.pad_targets(targets, 5, 3)
    assert valid.all()
    stats = variables["batch_stats"]
    xs = shard_spatial(smesh, jnp.asarray(x))
    out = jax.jit(lambda v, a: model.apply(v, a, train=False))(variables, xs)
    evals = {k: np.asarray(out[k]) for k in ("pred_logits", "pred_points")}
    crit = jc.SetCriterion(num_classes=2, weight_dict=pc.build_weight_dict(
        dec_layers=CLTR["dec_layers"]))
    tx = make_optimizer("SGD", LR, WD)

    def state():
        return jax.device_put(TrainState.create(
            jax.tree_util.tree_map(jnp.array, variables["params"]),
            jax.tree_util.tree_map(jnp.array, stats), tx),
            replicated_sharding(smesh))

    batch = shard_spatial(smesh, tuple(jnp.asarray(a) for a in (
        x, labels, points, valid)))
    rng_key = jax.random.key(7)
    costs = make_cltr_steps(model, crit, tx)[0](state(), *batch, rng_key)
    match = np.asarray(auction_lsap_batched(costs, jnp.broadcast_to(
        batch[3][None], (costs.shape[0],) + valid.shape)))
    after, loss, _ = make_cltr_fused_step(model, crit, tx)(
        state(), *batch, LR, rng_key)
    spec = {"kind": "cltr", "dropout": 0.1, "x": x, "labels": labels,
            "points": points, "valid": valid,
            "batch": ("x", "labels", "points", "valid"),
            "state": cltr_state_dict_from_flax(variables["params"], stats)}
    return spec, evals, float(loss), cltr_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, after.params), stats), match


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three meshes' ranks and the JAX side."""
    from unet_torch_tpu_torch.ckpt.bridge import (
        transunet_state_dict_from_flax,
    )

    from test_torch_port_parallel import _jax_setup
    from test_torch_port_spatial import _jax_spatial

    torch.set_num_threads(2)
    rng = np.random.RandomState(0)
    model, x, y, params, stats = _jax_setup("transunet", 4, IMG_VIT, rng)
    logits, after = _jax_spatial(model, params, stats, x, y)
    cltr_spec, cltr_eval, cltr_loss, cltr_after, cltr_match = _jax_cltr(rng)
    state = transunet_state_dict_from_flax(params, stats)
    torch.manual_seed(2)
    multitask = build_transunet("multitask").state_dict()
    step = {"kind": "transunet", "dropout": 0.1, "state": state, "x": x,
            "y": y, "batch": ("x", "y")}
    evals = {"transunet": ("single", state),
             "cltr": ("cltr", cltr_spec["state"])}
    base = {"x": x, "xc": cltr_spec["x"]}
    specs = {
        (1, 2): {**base, "mesh": (1, 2), "eval": {
            **evals, "multitask": ("multitask", multitask)}},
        (1, 4): {**base, "mesh": (1, 4), "eval": evals},
        (2, 2): {**base, "mesh": (2, 2),
                 "eval": {"transunet": ("single", state)},
                 "transunet_step": step, "cltr_step": cltr_spec},
    }
    path = os.path.abspath(__file__)
    ranks = {mesh: launch(path, spec, str(tmp_path_factory.mktemp(
        f"spatial_tf{mesh[0]}{mesh[1]}"))) for mesh, spec in specs.items()}
    return dict(ranks=ranks, x=x, params=params, stats=stats, logits=logits,
                loss=after[0], after=after[1:], step=step,
                multitask=multitask, cltr_spec=cltr_spec,
                cltr_eval=cltr_eval, cltr_loss=cltr_loss,
                cltr_after=cltr_after, cltr_match=cltr_match)


MESHES = [(1, 2), (1, 4), (2, 2)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("mesh", MESHES)
def test_transunet_eval_forward_matches_jax_on_shard_spatial(runs, mesh):
    """The strips' R50 (at M = 4 the pooled 15 rows split 4/4/4/3), each
    strip's tokens attending to every strip's keys, the decoder on the
    haloed strips: the gathered logits are JAX's, on every rank."""
    for r in runs["ranks"][mesh]:
        np.testing.assert_allclose(r["eval"]["transunet"][0].numpy(),
                                   runs["logits"], **TOL_EVAL)


@pytest.mark.timeout(300)
def test_multitask_transunet_eval_forward_matches_one_process(runs):
    """`multi_task_regTU`: the shared encoder and both decoders on the
    strips, each head's logits against the port's one-process forward."""
    model = build_transunet("multitask")
    model.load_state_dict(runs["multitask"])
    with torch.no_grad():
        ref = model.eval()(torch.from_numpy(runs["x"]))
    for r in runs["ranks"][(1, 2)]:
        for ours, want in zip(r["eval"]["multitask"], ref, strict=True):
            np.testing.assert_allclose(ours.numpy(), want.numpy(),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.timeout(300)
def test_transunet_spatial_step_matches_jax_make_single_steps(runs):
    """(D, M) = (2, 2): the state after one SGD step against JAX's on the
    spatially sharded batch, the loss alike on every rank."""
    from unet_torch_tpu_torch.ckpt.bridge import (
        transunet_state_dict_from_flax,
    )

    from test_torch_port_parallel import _check_against_jax

    ranks = runs["ranks"][(2, 2)]
    for r in ranks:
        np.testing.assert_allclose(r["transunet"]["plain"]["loss"],
                                   runs["loss"], **TOL_STEP)
    _check_against_jax("transunet", ranks[0]["transunet"], runs["x"],
                       runs["params"], runs["stats"], runs["after"],
                       transunet_state_dict_from_flax)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", ["plain", "dropout"])
def test_transunet_spatial_step_matches_one_process(runs, run):
    """Against the port's one-process step, through the parameters' steps;
    with dropout and attention dropout 0.1 each rank applies its rows and
    strip of the whole batch's masks (the attention's from the query-row
    offset). The ranks end with the same state, bit for bit."""
    from test_torch_port_parallel import _check_against_port

    results = [r["transunet"] for r in runs["ranks"][(2, 2)]]
    _check_against_port("transunet", runs["step"], results, run)
    first = results[0][run]
    assert any("running_var" in k for k in first["buffers"])
    for r in results[1:]:
        for k, v in first["state"].items():
            assert torch.equal(v, r[run]["state"][k]), k


@pytest.mark.timeout(300)
@pytest.mark.parametrize("mesh", [(1, 2), (1, 4)])
def test_cltr_forward_matches_jax_on_shard_spatial(runs, mesh):
    """The backbone and the encoder on the strips (at M = 4 one feature row
    a rank), the decoder replicated on the gathered memory: every rank's
    outputs are JAX's."""
    for r in runs["ranks"][mesh]:
        for k, want in runs["cltr_eval"].items():
            np.testing.assert_allclose(r["eval"]["cltr"][k].numpy(), want,
                                       err_msg=k, **TOL_EVAL)


@pytest.mark.timeout(300)
def test_cltr_spatial_step_matches_jax_fused_step(runs):
    """(2, 2): each rank matches its data rank's images on the auction,
    the matches JAX's; the state after the SGD step JAX's (the memory
    gather's backward sums the M ranks' copies of the one loss, and DDP's
    mean over the world group divides them out)."""
    ranks = runs["ranks"][(2, 2)]
    for r in ranks:
        res = r["cltr"]["plain"]
        rows = slice(2 * (r["rank"] // 2), 2 * (r["rank"] // 2) + 2)
        np.testing.assert_array_equal(res["match"].numpy(),
                                      runs["cltr_match"][:, rows])
        np.testing.assert_allclose(res["loss"], runs["cltr_loss"],
                                   **TOL_STEP)
    ours = ranks[0]["cltr"]["plain"]["state"]
    for name, ref in runs["cltr_after"].items():
        np.testing.assert_allclose(ours[name].numpy(), ref.numpy(),
                                   err_msg=name, **TOL_STEP)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", ["plain", "dropout"])
def test_cltr_spatial_step_matches_one_process(runs, run):
    from test_torch_port_parallel import _check_against_port

    _check_against_port("cltr", runs["cltr_spec"],
                        [r["cltr"] for r in runs["ranks"][(2, 2)]], run)


GRADCHECKS = ["exchange_rows_3_2", "exchange_rows_0_1", "all_gather_dim",
              "exclusive_prefix_sum", "strip_group_norm", "upsample_rows_2x"]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", GRADCHECKS)
@pytest.mark.parametrize("mesh", MESHES)
def test_strip_collectives_and_layers_pass_gradcheck(runs, mesh, name):
    """In f64 across the ranks: the adjoint of each strip collective and
    layer, and its forward against the whole image's (the GroupNorm over
    strips of 4, ..., 4, 3 rows)."""
    for r in runs["ranks"][mesh]:
        passed, err = r["gradcheck"][name]
        assert passed and err <= 1e-12, (name, err)


@pytest.mark.timeout(300)
def test_strip_upsample_matches_jax_interpolation_matrix(runs):
    """The strips' upsample, put together, against the JAX model's
    align-corners interpolation matrices on the whole input."""
    import jax.numpy as jnp

    from unet_torch_tpu.models.transunet.vit import _resize_align_corners

    for mesh in MESHES:
        for r in runs["ranks"][mesh]:
            x, got = (t.numpy() for t in r["gradcheck"]["upsample"])
            want = np.asarray(_resize_align_corners(
                jnp.asarray(x, jnp.float32), 2 * x.shape[1], 2 * x.shape[2]))
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# pytest alone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("offsets", [(0, 0, 3, 0), (1, 2, 5, 24),
                                     (0, 1, 4, 100)])
def test_keep_mask_with_a_query_row_offset_is_the_slice_of_the_whole(
        offsets):
    """A strip's mask (its query rows from q_off, with its batch rows and
    heads) is, bit for bit, its slice of the one-process mask, in the
    train attention's plain version and in the probe's."""
    from unet_torch_tpu_torch.kernels import attention as A

    b_off, h_off, h_total, q_off = offsets
    b, h, nq, nk = 2, 2, 24, 160
    whole = A._keep_mask(11, 0.3, (b_off + b, h_total, q_off + nq, nk), None,
                         "cpu")
    mine = A._keep_mask(11, 0.3, (b, h, nq, nk), None, "cpu", offsets)
    assert torch.equal(mine, whole[b_off:b_off + b, h_off:h_off + h,
                                   q_off:])
    probe = A.dropout_keep_mask(3, nq, nk, 11, 0.3, "cpu", q_off=q_off)
    whole = A.dropout_keep_mask(3, q_off + nq, nk, 11, 0.3, "cpu")
    assert torch.equal(probe, whole[:, q_off:])


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_strip_train_attention_is_the_whole_one_at_its_rows(rate):
    """Plain versions: two strips of queries against every key, each at its
    q_off, give the whole sequence's output, lse and dq at their rows, and
    their partial dk and dv add up to the whole's."""
    from unet_torch_tpu_torch.kernels import attention as A

    rng = np.random.RandomState(4)
    b, h, n, d = 2, 3, 48, 16
    q, k, v, g = (torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32))
                  for _ in range(4))
    o, lse = A.attention_train_reference(q, k, v, 0.25, seed=9, rate=rate)
    dq, dk, dv = A.attention_backward_reference(q, k, v, o, lse, g, 0.25,
                                                seed=9, rate=rate)
    sum_dk, sum_dv = torch.zeros_like(dk), torch.zeros_like(dv)
    for m in range(2):
        rows = slice(m * n // 2, (m + 1) * n // 2)
        offsets = (0, 0, h, m * n // 2)
        qs, gs = q[:, :, rows].contiguous(), g[:, :, rows].contiguous()
        os_, ls = A.attention_train_reference(qs, k, v, 0.25, seed=9,
                                              rate=rate, offsets=offsets)
        assert torch.equal(os_, o[:, :, rows])
        assert torch.equal(ls, lse.view(b, h, n)[:, :, rows].reshape(b * h,
                                                                    -1))
        dqs, dks, dvs = A.attention_backward_reference(
            qs, k, v, os_, ls, gs, 0.25, seed=9, rate=rate, offsets=offsets)
        torch.testing.assert_close(dqs, dq[:, :, rows], atol=1e-6, rtol=1e-6)
        sum_dk += dks
        sum_dv += dvs
    torch.testing.assert_close(sum_dk, dk, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(sum_dv, dv, atol=1e-5, rtol=1e-5)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("mesh", MESHES)
def test_strip_sine_embedding_equals_the_whole(runs, mesh):
    """Each strip's sine embedding of a padding mask (its own count plus
    the strips' above it, over the whole column's) is its rows of the
    whole mask's, bit for bit."""
    assert all(r["gradcheck"]["sine"] for r in runs["ranks"][mesh])


def _one_process_mesh(role="spatial"):
    from unet_torch_tpu_torch.core.mesh import Mesh

    return Mesh(data=1, model=2, rank=0, role=role)


@pytest.mark.parametrize("family,height,multiple", [
    ("transunet", 24, 16), ("cltr", 48, 32)])
def test_a_strip_height_the_family_cannot_split_raises(family, height,
                                                       multiple):
    """The hybrid TransUnet halves a strip four times, CLTR's ResNet-50
    five: a strip of another height raises with the reason, before any
    collective."""
    from unet_torch_tpu_torch.parallel.spatial import (
        check_strip,
        spatialize,
        strip_rule,
    )

    model = build_cltr() if family == "cltr" else build_transunet("single")
    rule = strip_rule(model)
    assert rule[0] == multiple
    check_strip(2 * multiple, rule)
    model = spatialize(model, _one_process_mesh())
    with pytest.raises(ValueError, match=f"multiple of {multiple}: .*halve"):
        model(torch.zeros(1, height, IMG_VIT, 3))


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
