"""Spatial (height) partitioning of the UNet family (parallel/spatial.py,
core/dist.py::exchange_rows) on the CPU over gloo, against the JAX
package's forward and step on `shard_spatial` and against the port's own
one-process step.

The ranks are this file run as a script,

    python tests/test_torch_port_spatial.py <rank> <world> <port> <out>

each reading `<out>/spec.pt` and writing `<out>/rank<rank>.pt`; they
import torch and the port alone. UNet base 8, 64x64, 3 classes:

  * (D, M) = (1, 2) and (2, 2): the eval forward of each rank's rows and
    strip, gathered, against the JAX forward on `shard_spatial` of
    `make_mesh(2, 2)`; at (1, 2) also the attention UNet's, and the
    two-head UNet's against the port's one-process forward;
  * (2, 2): one SGD step of `dice_bce_mc` (DistributedDataParallel and the
    loss's Dice sums over the world group, train-mode BN over it) against
    `make_single_steps` on the spatially sharded batch, the BN buffers
    bitwise equal across the ranks; with dropout 0.5 (each rank's rows and
    strip of the whole batch's mask) and without, against the port's
    one-process step;
  * `exchange_rows` by `torch.autograd.gradcheck` in f64 over each mesh:
    the strips of a whole input, exchanged, put back together.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
LR, WD = 0.1, 1e-4


def build_model(kind, dropout=0.0):
    from unet_torch_tpu_torch.models.unet import (
        UNet,
        UNetAttention,
        UNetMultitask,
    )

    cls = {"attention": UNetAttention, "multitask": UNetMultitask}.get(
        kind, UNet)
    return cls(3, 3, base=8, dropout=dropout > 0, dropout_p=dropout)


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _gradcheck(mesh):
    """gradcheck of the whole input's strips, exchanged and put back
    together, in f64: the forward and the adjoint over the ranks."""
    from unet_torch_tpu_torch.core.dist import (
        copy_to_group,
        exchange_rows,
        reduce_from_group,
    )

    group = mesh.world_group
    rows, strip = mesh.rows(mesh.data), mesh.strip(2 * mesh.model)

    def f(x):
        # copy_to_group: every rank's share of the gradient of the whole x
        y = exchange_rows(copy_to_group(x, group)[rows, :, strip],
                          mesh.model_group)
        full = x.new_zeros((x.shape[0], 2, 4 * mesh.model, 3))
        full[rows, :, 4 * mesh.m:4 * (mesh.m + 1)] = y
        return reduce_from_group(full, group)

    gen = torch.Generator().manual_seed(3)
    x = torch.randn((mesh.data, 2, 2 * mesh.model, 3), generator=gen,
                    dtype=torch.float64, requires_grad=True)
    return torch.autograd.gradcheck(f, (x,))


def _spatial_step(spec, dropout, mesh):
    """One SGD step of the spatially partitioned UNet on the rank's rows
    and strip; returns (loss, model)."""
    from torch.nn.parallel import DistributedDataParallel

    from unet_torch_tpu_torch.parallel.spatial import (
        shard_spatial,
        spatialize,
    )
    from unet_torch_tpu_torch.train.optim import make_optimizer
    from unet_torch_tpu_torch.train.steps import make_single_steps

    model = build_model("unet", dropout)
    model.load_state_dict(spec["state"], strict=True)
    spatialize(model, mesh)
    net = DistributedDataParallel(model, process_group=mesh.world_group,
                                  broadcast_buffers=False)
    x, y = shard_spatial(mesh, [spec["x"], spec["y"]], "cpu")
    opt = make_optimizer("SGD", model.parameters(), LR, WD)
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", 3,
                                group=mesh.world_group)
    loss = step(net, opt, x, y, LR, torch.Generator().manual_seed(5))
    return float(loss), model


def _rank_case(spec):
    from unet_torch_tpu_torch.core.mesh import make_mesh
    from unet_torch_tpu_torch.parallel.spatial import (
        gather_spatial,
        shard_spatial,
        spatialize,
    )

    mesh = make_mesh(*spec["mesh"], role="spatial")
    result = {"rank": mesh.rank, "gradcheck": _gradcheck(mesh)}
    for kind, state in spec["eval"].items():
        model = build_model(kind)
        model.load_state_dict(state, strict=True)
        spatialize(model, mesh).eval()
        (x,) = shard_spatial(mesh, [spec["x"]], "cpu")
        with torch.no_grad():
            out = model(x)
            result[f"eval_{kind}"] = (
                tuple(gather_spatial(o, mesh) for o in out)
                if isinstance(out, tuple) else gather_spatial(out, mesh))
    if "y" in spec:
        for name, dropout in (("plain", 0.0), ("dropout", spec["dropout"])):
            loss, model = _spatial_step(spec, dropout, mesh)
            result[name] = {"loss": loss, "state": model.state_dict(),
                            "buffers": {k: v.clone()
                                        for k, v in model.named_buffers()}}
    return result


def run_rank(rank, world, port, out, case):
    """One rank of `launch`, in its own process: torch.distributed over
    gloo, `case(spec)`'s result to `<out>/rank<rank>.pt`, then a barrier
    and the process group's end, so that no rank leaves while another
    still talks to it (a gloo rank that exits with its group alive may
    abort in its threads' teardown, after its work is done)."""
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from unet_torch_tpu_torch.core.dist import maybe_initialize

    maybe_initialize(force=True, backend="gloo")
    spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
    torch.save(case(spec), os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the pytest side
# --------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(path, spec, out):
    """Run the spec's ranks, `path` run as a script; returns their results
    in rank order."""
    world = spec["mesh"][0] * spec["mesh"][1]
    torch.save(spec, os.path.join(out, "spec.pt"))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, path, str(r), str(world), str(port), str(out)],
        cwd=out, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"a rank failed:\n{log[-4000:]}"
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _jax_attention_setup(rng):
    import jax
    import jax.numpy as jnp

    from unet_torch_tpu.models.unet import UNetAttention as JaxUNetAttention

    from test_torch_port_unet_family import _seeded

    model = JaxUNetAttention(3, 3, base=8)
    variables = model.init(jax.random.key(1),
                           jnp.zeros((1, IMG, IMG, 3), jnp.float32),
                           train=False)
    return (model, *_seeded(variables, rng))


def _jax_spatial(model, params, stats, x, y=None):
    """The JAX forward on the spatially sharded batch over make_mesh(2, 2)
    and, given labels, its make_single_steps SGD step there."""
    import jax
    import jax.numpy as jnp

    from unet_torch_tpu.core.mesh import make_mesh, replicated_sharding
    from unet_torch_tpu.parallel.spatial import shard_spatial
    from unet_torch_tpu.train.optim import make_optimizer
    from unet_torch_tpu.train.state import TrainState
    from unet_torch_tpu.train.steps import make_single_steps

    smesh = make_mesh(2, 2, devices=jax.devices()[:4])
    xs = shard_spatial(smesh, jnp.asarray(x))
    variables = {"params": params, "batch_stats": stats}
    logits = np.asarray(jax.jit(lambda v, a: model.apply(
        v, a, train=False))(variables, xs))
    if y is None:
        return logits, None
    tx = make_optimizer("SGD", LR, WD)
    state = jax.device_put(TrainState.create(
        jax.tree_util.tree_map(jnp.array, params),
        jax.tree_util.tree_map(jnp.array, stats), tx),
        replicated_sharding(smesh))
    step, _ = make_single_steps(model, tx, "dice_bce_mc", "dice_bce_mc", 3)
    xb, yb = shard_spatial(smesh, (jnp.asarray(x), jnp.asarray(y)))
    state, loss = step(state, xb, yb, LR, jax.random.key(1))
    return logits, (float(loss),
                    jax.tree_util.tree_map(np.asarray, state.params),
                    jax.tree_util.tree_map(np.asarray, state.batch_stats))


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    """Both meshes' ranks and the JAX side."""
    from unet_torch_tpu_torch.ckpt.bridge import (
        attention_state_dict_from_flax,
        state_dict_from_flax,
    )

    from test_torch_port_parallel import _jax_setup

    torch.set_num_threads(2)
    rng = np.random.RandomState(0)
    model, x, y, params, stats = _jax_setup("unet", 8, IMG, rng)
    logits, after = _jax_spatial(model, params, stats, x, y)
    att_model, att_params, att_stats = _jax_attention_setup(rng)
    att_logits, _ = _jax_spatial(att_model, att_params, att_stats, x)
    state = state_dict_from_flax(params, stats)
    base = {"kind": "unet", "state": state, "x": x, "dropout": 0.5}
    torch.manual_seed(2)
    spec12 = {**base, "mesh": (1, 2), "eval": {
        "unet": state,
        "attention": attention_state_dict_from_flax(att_params, att_stats),
        "multitask": build_model("multitask").state_dict()}}
    spec22 = {**base, "mesh": (2, 2), "eval": {"unet": state}, "y": y,
              "batch": ("x", "y")}
    path = os.path.abspath(__file__)
    runs = {mesh: launch(path, spec, str(tmp_path_factory.mktemp(
        f"spatial{mesh[0]}{mesh[1]}")))
        for mesh, spec in (((1, 2), spec12), ((2, 2), spec22))}
    return dict(runs=runs, spec=spec22, spec12=spec12, x=x, params=params,
                stats=stats,
                logits=logits, att_logits=att_logits, loss=after[0],
                after=after[1:])


TOL_EVAL = dict(atol=2e-4, rtol=1e-3)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_spatial_eval_forward_matches_jax_on_shard_spatial(spatial_runs,
                                                           mesh):
    """Each rank's strip, with its neighbours' rows before every 3x3 conv
    and the fused conv on the haloed strip, gathered: the whole batch's
    logits, on every rank."""
    for r in spatial_runs["runs"][mesh]:
        np.testing.assert_allclose(r["eval_unet"].numpy(),
                                   spatial_runs["logits"], **TOL_EVAL)


@pytest.mark.timeout(300)
def test_spatial_attention_unet_eval_forward_matches_jax(spatial_runs):
    """The attention gates' 1x1 convs and transposed convs read no other
    strip: the DoubleConvs' halos cover the attention UNet."""
    for r in spatial_runs["runs"][(1, 2)]:
        np.testing.assert_allclose(r["eval_attention"].numpy(),
                                   spatial_runs["att_logits"], **TOL_EVAL)


@pytest.mark.timeout(300)
def test_spatial_multitask_unet_eval_forward_matches_one_process(
        spatial_runs):
    """`multi_task` / `multi_task_reg`: the shared encoder and both
    decoders on the strips, each head's logits against the port's
    one-process forward."""
    model = build_model("multitask")
    model.load_state_dict(spatial_runs["spec12"]["eval"]["multitask"])
    with torch.no_grad():
        ref = model.eval()(torch.from_numpy(spatial_runs["x"]))
    for r in spatial_runs["runs"][(1, 2)]:
        for ours, want in zip(r["eval_multitask"], ref, strict=True):
            np.testing.assert_allclose(ours.numpy(), want.numpy(),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.timeout(300)
def test_spatial_step_matches_jax_make_single_steps(spatial_runs):
    """(D, M) = (2, 2): DDP and the Dice sums over the world group, BN
    statistics over every rank's pixels; the state after the step against
    JAX's on the spatially sharded batch."""
    from unet_torch_tpu_torch.ckpt.bridge import state_dict_from_flax

    from test_torch_port_parallel import TOL_JAX, _check_against_jax

    s = spatial_runs
    for res in s["runs"][(2, 2)]:
        np.testing.assert_allclose(res["plain"]["loss"], s["loss"],
                                   **TOL_JAX)
    _check_against_jax("unet", s["runs"][(2, 2)][0], s["x"], s["params"],
                       s["stats"], s["after"], state_dict_from_flax)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", ["plain", "dropout"])
def test_spatial_step_matches_one_process_and_buffers_agree(spatial_runs,
                                                            run):
    """Against the port's one-process step on the whole batch, through the
    parameters' SGD steps (a term off by a factor of the world size would
    show); with dropout 0.5, each rank applies its rows and strip of the
    whole batch's mask. The four ranks end with the same parameters and
    running statistics, bit for bit."""
    from test_torch_port_parallel import _check_against_port

    results = spatial_runs["runs"][(2, 2)]
    _check_against_port("unet", spatial_runs["spec"], results, run)
    first = results[0][run]
    assert any("running_var" in k for k in first["buffers"])
    for r in results[1:]:
        for k, v in first["buffers"].items():
            assert torch.equal(v, r[run]["buffers"][k]), k
        for k, v in first["state"].items():
            assert torch.equal(v, r[run]["state"][k]), k


@pytest.mark.timeout(300)
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_exchange_rows_passes_gradcheck(spatial_runs, mesh):
    assert all(r["gradcheck"] for r in spatial_runs["runs"][mesh])


def _one_process_mesh(role="spatial"):
    from unet_torch_tpu_torch.core.mesh import Mesh

    return Mesh(data=1, model=2, rank=0, role=role)


def test_a_strip_not_a_multiple_of_16_rows_raises():
    """UNet-8 on a 64-row image over M = 2 takes strips of 32; a 40-row
    strip would pool rows of two strips."""
    from unet_torch_tpu_torch.parallel.spatial import check_strip, spatialize

    check_strip(32)
    model = spatialize(build_model("unet"), _one_process_mesh())
    with pytest.raises(ValueError, match="multiple of 16"):
        model(torch.zeros(1, 40, 64, 3))


def test_spatialize_refuses_transformers_and_other_roles():
    """The transformer families are spatially partitioned too (their
    strip layers take the mesh; tests/test_torch_port_spatial_transformers.py
    runs them); a mesh of another role, or a module of no family, is
    refused."""
    from unet_torch_tpu_torch.models import cltr as pc
    from unet_torch_tpu_torch.models.transunet.vit import VisionTransformer
    from unet_torch_tpu_torch.parallel.spatial import spatialize

    from test_torch_port_parallel import CLTR, vit_config
    from unet_torch_tpu_torch.models.transunet.configs import CONFIGS

    mesh = _one_process_mesh()
    vit = spatialize(VisionTransformer(vit_config(CONFIGS), 64, 3), mesh)
    cltr = spatialize(pc.ConditionalDETR(**CLTR), mesh)
    assert vit.transformer.encoder.layer[0].attn.mesh is mesh
    assert cltr.transformer.encoder.layers[0].self_attn.mesh is mesh
    with pytest.raises(TypeError, match="none of the spatially"):
        spatialize(torch.nn.Linear(2, 2), mesh)
    with pytest.raises(ValueError, match="'spatial' role"):
        spatialize(build_model("unet"), _one_process_mesh("tensor"))


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
             sys.argv[4], _rank_case)
