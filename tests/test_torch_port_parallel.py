"""The port's multi-process training (core/dist.py, core/mesh.py,
nn/sync_batchnorm.py, parallel/tensor.py, the data group of the losses and
steps) on the CPU over gloo, against the JAX package's sharded steps and
against the port's own one-process step.

The ranks are this file run as a script,

    python tests/test_torch_port_parallel.py <rank> <world> <port> <out>

each reading `<out>/spec.pt` (the case, the weights, the global batch) and
writing `<out>/rank<rank>.pt`; they import torch and the port alone. The
JAX side and the one-process port step run in the pytest process, from the
same numpy-seeded inputs and the same bridged weights:

  * UNet base 8, 32x32, `dice_bce_mc`, train-mode BN, D = 2: one SGD step
    against `make_single_steps` on the 8-device mesh; with dropout on,
    against the port's one-process step; the running buffers bitwise equal
    across ranks; then the train CLI over both ranks (one logs.txt, the
    checkpoints written once and loadable in one process); and the
    two-head UNet's `ratio` step, a product of two batch means, against
    the port's one-process step;
  * TransUnet (hybrid, ViT width 64, 4 heads, 2 layers), (D, M) = (2, 2):
    one SGD step against `shard_state_tp` on `make_mesh(4, 2)`; with
    dropout and attention dropout on, against the port's one-process step;
    the gathered state before the step equal, bit for bit, to the state the
    ranks were given; and at (D, M) = (1, 4), one head a rank, in f64,
    against the one-process f64 step to f64's rounding (tensor parallelism
    changes no value but by the order of its sums);
  * tiny CLTR, D = 2 (auction matcher): one SGD step against
    `make_cltr_fused_step` on the mesh; with dropout on, against the port's
    one-process step.

SGD: Adam's first step is lr * sign(g), which turns a reduction-order flip
of a tiny gradient into 2 lr. Against JAX the parameters after the step are
held elementwise at the existing step bounds; against the port's
one-process step also through their steps, (before - after) / lr, SGD's
first step being lr times the decayed gradient: a gradient off by the
factor D of a term formed over the whole batch shows there, where it would
hide in the parameters themselves (lr 0.1 keeps the f32 rounding of the
stored parameters, an ulp over lr, below the bounds). Those bounds are
relative to each tensor's peak (an absolute 1e-5 failed at 1.001e-05 on a
card before), or a multiple of the one-process f32 step's own error against
f64 where rounding flips a ReLU. SyncBatchNorm2d's variance is two-pass
where flax's is one-pass: the steps of the first UNet conv differ from
JAX's by about 1e-4 at this size, the rounding of flax's form, which the
parameters' bound covers.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_UNET, IMG_VIT, IMG_CLTR = 32, 64, 64
TOL_JAX = dict(atol=1e-4, rtol=1e-3)
TOL_SELF = dict(atol=1e-5, rtol=1e-4)
# the multi-rank step against the one-process f32 step: at most this many
# times the one-process f32 step's own error against its f64 step (as
# chip_smoke.py's T4 holds the card's gradients)
NOISE_RATIO = 10.0
LR, WD = 0.1, 1e-4
CLTR = dict(num_queries=16, hidden_dim=32, nheads=4, enc_layers=1,
            dec_layers=2, dim_feedforward=64, dropout_rate=0.0,
            backbone_layers=(1, 1, 1, 1))


def vit_config(configs, dropout=0.0):
    """The small hybrid TransUnet at ViT width 64 with 4 heads, from either
    registry."""
    import copy

    c = copy.deepcopy(configs["R50-ViT-B_16"])
    c.hidden_size = 64
    c.transformer.mlp_dim = 128
    c.transformer.num_layers = 2
    c.transformer.num_heads = 4
    c.transformer.dropout_rate = dropout
    c.transformer.attention_dropout_rate = dropout
    c.n_classes = 3
    c.n_skip = 3
    c.decoder_channels = (256, 128, 64, 16)
    c.patches.grid = (IMG_VIT // 16, IMG_VIT // 16)
    c.resnet.num_layers = (1, 1, 1)
    return c


# --------------------------------------------------------------------------
# the port's side: models, one step, in one process or on a rank
# --------------------------------------------------------------------------

def build_model(kind, dropout):
    if kind == "unet":
        from unet_torch_tpu_torch.models.unet import UNet

        return UNet(3, 3, base=8, dropout=dropout > 0, dropout_p=dropout)
    if kind == "multitask":
        from unet_torch_tpu_torch.models.unet import UNetMultitask

        return UNetMultitask(3, 1, base=8)
    if kind == "transunet":
        from unet_torch_tpu_torch.models.transunet.configs import CONFIGS
        from unet_torch_tpu_torch.models.transunet.vit import (
            VisionTransformer,
        )

        return VisionTransformer(vit_config(CONFIGS, dropout), IMG_VIT, 3)
    from unet_torch_tpu_torch.models import cltr as pc

    return pc.ConditionalDETR(**{**CLTR, "dropout_rate": dropout})


def port_step(spec, dropout, mesh=None, dtype=torch.float32):
    """One SGD step of the port on the spec's batch (the rank's rows of it
    with a mesh), in `dtype`; returns (loss, model)."""
    from unet_torch_tpu_torch.parallel import parallelize
    from unet_torch_tpu_torch.train.optim import make_optimizer

    kind = spec["kind"]
    model = build_model(kind, dropout)
    model.load_state_dict(spec["state"], strict=True)
    model.to(dtype)
    if hasattr(model, "dtype"):  # CLTR casts its inputs to it
        model.dtype = dtype
    parallelize(model, mesh)
    group = None if mesh is None else mesh.data_group
    net = model
    if group is not None:
        from torch.nn.parallel import DistributedDataParallel

        net = DistributedDataParallel(model, process_group=group,
                                      broadcast_buffers=False)
    rows = slice(None) if mesh is None else mesh.rows(len(spec["x"]))
    batch = [torch.from_numpy(spec[k][rows]) for k in spec["batch"]]
    batch = [t.to(dtype) if t.is_floating_point() else t for t in batch]
    opt = make_optimizer("SGD", model.parameters(), LR, WD)
    generator = torch.Generator().manual_seed(5)
    if kind == "cltr":
        from unet_torch_tpu_torch.models import cltr as pc
        from unet_torch_tpu_torch.train import cltr_steps

        crit = pc.SetCriterion(num_classes=2, weight_dict=pc.build_weight_dict(
            dec_layers=CLTR["dec_layers"]))
        loss, _ = cltr_steps.train_step(
            net, crit, opt, *batch, LR, generator,
            torch.Generator().manual_seed(6), "auction", group)
    elif kind == "multitask":
        from unet_torch_tpu_torch.train.steps import make_multitask_steps

        step, _ = make_multitask_steps("mse", 1, combine="ratio",
                                       group=group)
        loss = step(net, opt, *batch, LR, generator, torch.tensor(True))[0]
    else:
        from unet_torch_tpu_torch.train.steps import make_single_steps

        step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", 3,
                                    group=group)
        loss = step(net, opt, *batch, LR, generator)
    return float(loss), model


def vis_forwards(spec, mesh, shard, gather):
    """The TransUnet of the spec's state with vis=True and with vis=False,
    each placed on `mesh` by `shard(model)`, their eval forwards on the
    rank's input `x`: {"weights": every layer's attn_weights as the rank
    holds them, "gathered": each passed through `gather`, "logits":
    {vis: the forward's logits}}."""
    from unet_torch_tpu_torch.models.transunet.configs import CONFIGS
    from unet_torch_tpu_torch.models.transunet.vit import VisionTransformer

    out = {"logits": {}}
    for vis in (True, False):
        model = VisionTransformer(vit_config(CONFIGS), IMG_VIT, 3, vis=vis)
        model.load_state_dict(spec["state"], strict=True)
        shard(model).eval()
        with torch.no_grad():
            out["logits"][vis] = model(spec["x"])
        if vis:
            out["weights"] = model.attn_weights
            out["gathered"] = [gather(w) for w in model.attn_weights]
    return out


def _rank_case(spec, out):
    """What a rank runs: the case's steps, each from the spec's weights."""
    from unet_torch_tpu_torch.core.mesh import make_mesh
    from unet_torch_tpu_torch.parallel import gather_state_tp, parallelize

    mesh = make_mesh(*spec["mesh"])
    if spec["kind"] == "vis":
        return vis_forwards({**spec, "x": torch.from_numpy(spec["x"])}, mesh,
                            lambda model: parallelize(model, mesh),
                            lambda w: w)
    result = {"rank": mesh.rank}
    if spec["kind"] == "transunet":
        model = build_model("transunet", 0.0)
        model.load_state_dict(spec["state"], strict=True)
        result["gathered_before"] = gather_state_tp(parallelize(model, mesh),
                                                    mesh)
    dtype = getattr(torch, spec.get("dtype", "float32"))
    for name, dropout in (("plain", 0.0), ("dropout", spec["dropout"])):
        loss, model = port_step(spec, dropout, mesh, dtype)
        result[name] = {"loss": loss,
                        "state": gather_state_tp(model, mesh),
                        "buffers": {k: v.clone()
                                    for k, v in model.named_buffers()}}
    if "multitask" in spec:
        loss, model = port_step(spec["multitask"], 0.0, mesh)
        result["multitask"] = {"loss": loss, "state": model.state_dict()}
    if "cli" in spec:
        from unet_torch_tpu_torch.cli import train_cli
        from unet_torch_tpu_torch.cli.config import Config

        train_cli.run_training(Config.from_dict(spec["cli"]), device="cpu",
                               backend="gloo")
    return result


def _rank_main(rank, world, port, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from unet_torch_tpu_torch.core.dist import maybe_initialize

    maybe_initialize(force=True, backend="gloo")
    spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
    torch.save(_rank_case(spec, out), os.path.join(out, f"rank{rank}.pt"))


# --------------------------------------------------------------------------
# the pytest side
# --------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(spec, out):
    """Run the spec's ranks; returns their results in rank order."""
    world = spec["mesh"][0] * spec["mesh"][1]
    torch.save(spec, os.path.join(out, "spec.pt"))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), str(out)], cwd=out, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"a rank failed:\n{log[-4000:]}"
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _peak_close(ours, ref, tol, name):
    """Each tensor within tol of its reference, rtol relative to the
    reference's peak."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    peak = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(ours - ref).max()) if ref.size else 0.0
    assert err <= tol["atol"] + tol["rtol"] * peak, (name, err, peak)


def _jax_setup(kind, n, img, rng):
    """(flax model, numpy params, numpy batch_stats) with norm scales,
    biases, embeddings and BN statistics drawn away from their init."""
    import functools

    import jax
    import jax.numpy as jnp

    from test_torch_port_transunet import _seeded_stats

    if kind == "unet":
        from unet_torch_tpu.models.unet import UNet as JaxUNet

        model = JaxUNet(3, 3, base=8)
    else:
        from unet_torch_tpu.models.transunet import CONFIGS as JAX_CONFIGS
        from unet_torch_tpu.models.transunet import VisionTransformer

        model = VisionTransformer(vit_config(JAX_CONFIGS), img_size=img,
                                  num_classes=3)
    x = rng.randn(n, img, img, 3).astype(np.float32)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(0), jnp.asarray(x[:1]))

    def draw(path, a):
        a = np.asarray(a)
        if path[-1].key == "scale":
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        if path[-1].key in ("bias", "position_embeddings"):
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(draw, variables["params"])
    stats = _seeded_stats(rng, variables["batch_stats"])
    y = rng.randint(0, 3, x.shape[:3]).astype(np.float32)
    return model, x, y, params, stats


def _jax_single_step(model, params, stats, x, y, run_mesh, place):
    """The JAX package's make_single_steps SGD step on `run_mesh`, the batch
    sharded over `data`, the state placed by `place`."""
    import jax
    import jax.numpy as jnp

    from unet_torch_tpu.core.mesh import shard_batch
    from unet_torch_tpu.train.optim import make_optimizer
    from unet_torch_tpu.train.state import TrainState
    from unet_torch_tpu.train.steps import make_single_steps

    tx = make_optimizer("SGD", LR, WD)
    state = place(TrainState.create(
        jax.tree_util.tree_map(jnp.array, params),
        jax.tree_util.tree_map(jnp.array, stats), tx), tx)
    step, _ = make_single_steps(model, tx, "dice_bce_mc", "dice_bce_mc", 3)
    xb, yb = shard_batch(run_mesh, (jnp.asarray(x), jnp.asarray(y)))
    state, loss = step(state, xb, yb, LR, jax.random.key(1))
    return (float(loss), jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats))


def _check_against_jax(kind, result, x, params, stats, after, bridge):
    """The ranks' gathered state after the step against the JAX step's:
    every parameter, the running means, and the running variances with
    torch's unbiased update over the global count."""
    from test_torch_port_train_step import _bn_counts

    before = bridge(params, stats)
    ref = bridge(*after)
    ours = result["plain"]["state"]
    assert set(ours) == set(ref)
    model = build_model(kind, 0.0)
    model.load_state_dict(before)
    counts = _bn_counts(model, x)
    assert counts
    names = [n for n, _ in model.named_parameters()]
    for name in names:
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(),
                                   err_msg=name, **TOL_JAX)
    for prefix, n in counts.items():
        mean, var = f"{prefix}.running_mean", f"{prefix}.running_var"
        _peak_close(ours[mean], ref[mean], TOL_JAX, mean)
        old = 0.9 * before[var].numpy()
        expect = old + (ref[var].numpy() - old) * n / (n - 1)
        _peak_close(ours[var], expect, TOL_JAX, var)


def _step(after, before):
    return (before.double() - after.double()) / LR


def _check_against_port(kind, spec, results, run):
    """The ranks' step `run` ("plain": dropout 0; "dropout") against the
    port's one-process step on the whole batch, from the same generators:
    the parameters within TOL_SELF; their steps within TOL_SELF of their
    peaks, or, where larger, NOISE_RATIO times the one-process f32 step's
    own error against its f64 step (a ReLU that rounding flips moves the
    train-mode BatchNorm gradients of every layer before it)."""
    dropout = spec["dropout"] if run == "dropout" else 0.0
    loss, model = port_step(spec, dropout)
    ref = model.state_dict()
    ref64 = port_step(spec, dropout, dtype=torch.float64)[1].state_dict()
    for r in results:
        assert r[run]["loss"] == pytest.approx(loss, rel=1e-5)
    ours = results[0][run]["state"]
    assert set(ours) == set(ref)
    params = {n for n, _ in model.named_parameters()}
    for name, t in ref.items():
        if t.is_floating_point():
            _peak_close(ours[name], t, TOL_SELF, name)
        if name in params:
            before = spec["state"][name]
            step, step32 = _step(ours[name], before), _step(t, before)
            noise = (step32 - _step(ref64[name], before)).abs().max().item()
            err = (step - step32).abs().max().item()
            bound = max(TOL_SELF["atol"] + TOL_SELF["rtol"]
                        * step32.abs().max().item(), NOISE_RATIO * noise)
            assert err <= bound, (name, err, bound, noise)
    # the step changed the parameters: the comparison is not empty
    assert any(not torch.equal(spec["state"][k], ref[k]) for k in ref)


@pytest.fixture(scope="module")
def unet_run(tmp_path_factory, mesh):
    from unet_torch_tpu.core.mesh import replicated_sharding
    from unet_torch_tpu_torch.ckpt.bridge import state_dict_from_flax
    from unet_torch_tpu_torch.data.synthetic import write_synthetic_dataset

    from test_torch_port_train_e2e import _cfg

    out = tmp_path_factory.mktemp("unet_dp")
    rng = np.random.RandomState(0)
    model, x, y, params, stats = _jax_setup("unet", 8, IMG_UNET, rng)
    import jax

    after = _jax_single_step(model, params, stats, x, y, mesh,
                             lambda st, tx: jax.device_put(
                                 st, replicated_sharding(mesh)))
    root = out / "data"
    for split, seed in (("train", 1), ("val", 2)):
        write_synthetic_dataset(str(root / split), n_images=4, size=64,
                                n_classes=3, seed=seed)
    cli = _cfg(root, out / "run", "single", epochs=2, test=False)
    cli["train_config"]["batch_size"] = 4
    torch.manual_seed(0)
    y1, y2 = (rng.rand(8, IMG_UNET, IMG_UNET).astype(np.float32) * s
              for s in (2.0, 3.0))
    multitask = {"kind": "multitask", "mesh": (2, 1), "dropout": 0.0,
                 "state": build_model("multitask", 0.0).state_dict(),
                 "x": x, "y1": y1, "y2": y2, "batch": ("x", "y1", "y2")}
    spec = {"kind": "unet", "mesh": (2, 1), "dropout": 0.5,
            "state": state_dict_from_flax(params, stats), "x": x, "y": y,
            "batch": ("x", "y"), "cli": cli, "multitask": multitask}
    results = _launch(spec, str(out))
    return dict(spec=spec, results=results, x=x, params=params, stats=stats,
                after=after[1:], loss=after[0], out=out)


@pytest.mark.timeout(300)
def test_unet_data_parallel_step_matches_jax_on_the_mesh(unet_run):
    from unet_torch_tpu_torch.ckpt.bridge import state_dict_from_flax

    r = unet_run
    for res in r["results"]:
        np.testing.assert_allclose(res["plain"]["loss"], r["loss"],
                                   **TOL_JAX)
    _check_against_jax("unet", r["results"][0], r["x"], r["params"],
                       r["stats"], r["after"], state_dict_from_flax)


@pytest.mark.timeout(300)
def test_unet_data_parallel_buffers_equal_across_ranks(unet_run):
    """SyncBatchNorm2d: every rank ends the step with the same running
    statistics, bit for bit, and the same parameters."""
    a, b = (res["plain"] for res in unet_run["results"])
    assert any("running_var" in k for k in a["buffers"])
    for k, v in a["buffers"].items():
        assert torch.equal(v, b["buffers"][k]), k
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k


@pytest.mark.timeout(300)
def test_unet_data_parallel_dropout_step_matches_one_process(unet_run):
    """Dropout 0.5 on the UNet's Down and Up blocks: each rank applies its
    rows of the whole batch's mask."""
    _check_against_port("unet", unet_run["spec"], unet_run["results"],
                        "dropout")


@pytest.mark.timeout(300)
def test_multitask_ratio_step_over_two_ranks_matches_one_process(unet_run):
    """combine="ratio" with use_ratio: (l1 + l2) * (1 + 10 * mean |ratio
    error|) multiplies two means over the batch, so a rank's product of
    its own means is no share of the one-process loss; the step forms both
    over the whole batch."""
    spec = unet_run["spec"]["multitask"]
    results = [{"plain": r["multitask"]} for r in unet_run["results"]]
    loss = results[0]["plain"]["loss"]
    assert np.isfinite(loss)
    _check_against_port("multitask", spec, results, "plain")


@pytest.mark.timeout(300)
def test_unet_train_cli_over_two_ranks(unet_run):
    """`run_training` on both ranks (mesh: {}, D = 2): rank 0 alone writes
    the logs and checkpoints, once, and best.pt loads into a model built in
    one process."""
    from unet_torch_tpu_torch.ckpt import load_weights
    from unet_torch_tpu_torch.models.unet import UNet

    run = unet_run["out"] / "run"
    seed_dir = run / "run_seed7"
    logs = (seed_dir / "logs.txt").read_text()
    assert logs.count("Epoch 1/2") == 1 and logs.count("Epoch 2/2") == 1
    models = seed_dir / "models"
    assert (models / "last_epoch.pt").exists()
    assert (models / "best.pt").exists()
    load_weights(str(models / "best.pt"), UNet(3, 3, base=8))
    assert (run / "config.json").exists()


@pytest.fixture(scope="module")
def transunet_run(tmp_path_factory):
    import jax

    from unet_torch_tpu.core.mesh import make_mesh
    from unet_torch_tpu.parallel.tensor import shard_state_tp
    from unet_torch_tpu_torch.ckpt.bridge import (
        transunet_state_dict_from_flax,
    )

    out = tmp_path_factory.mktemp("transunet_tp")
    rng = np.random.RandomState(1)
    model, x, y, params, stats = _jax_setup("transunet", 8, IMG_VIT, rng)
    tp_mesh = make_mesh(n_data=4, n_model=2)
    after = _jax_single_step(model, params, stats, x, y, tp_mesh,
                             lambda st, tx: shard_state_tp(tp_mesh, st, tx))
    spec = {"kind": "transunet", "mesh": (2, 2), "dropout": 0.1,
            "state": transunet_state_dict_from_flax(params, stats), "x": x,
            "y": y, "batch": ("x", "y")}
    results = _launch(spec, str(out))
    del jax
    return dict(spec=spec, results=results, x=x, params=params, stats=stats,
                after=after[1:], loss=after[0])


@pytest.mark.timeout(300)
def test_transunet_tensor_parallel_step_matches_jax_shard_state_tp(
        transunet_run):
    from unet_torch_tpu_torch.ckpt.bridge import (
        transunet_state_dict_from_flax,
    )

    r = transunet_run
    for res in r["results"]:
        np.testing.assert_allclose(res["plain"]["loss"], r["loss"],
                                   **TOL_JAX)
    _check_against_jax("transunet", r["results"][0], r["x"], r["params"],
                       r["stats"], r["after"], transunet_state_dict_from_flax)


@pytest.mark.timeout(300)
def test_transunet_tensor_parallel_dropout_step_matches_one_process(
        transunet_run):
    """Dropout and attention dropout 0.1 at (D, M) = (2, 2): fc1's columns,
    the batch rows and the attention heads of the whole batch's masks."""
    _check_against_port("transunet", transunet_run["spec"],
                        transunet_run["results"], "dropout")


@pytest.mark.timeout(300)
def test_tensor_parallel_checkpoint_gathers_the_one_process_state(
        transunet_run):
    """gather_state_tp of the sharded model is the state dict it was given,
    bit for bit, on every rank; after the step the gathered states of the
    four ranks are equal and load strictly into a one-process model."""
    spec, results = transunet_run["spec"], transunet_run["results"]
    for res in results:
        assert set(res["gathered_before"]) == set(spec["state"])
        for k, v in spec["state"].items():
            assert torch.equal(res["gathered_before"][k], v), k
        for k, v in results[0]["dropout"]["state"].items():
            assert torch.equal(res["dropout"]["state"][k], v), k
    state = results[0]["dropout"]["state"]
    # fc1 was split over the two model ranks; the gathered one is whole
    assert state["transformer.encoder.layer.0.ffn.fc1.weight"].shape == (
        128, 64)
    build_model("transunet", 0.0).load_state_dict(state, strict=True)


@pytest.fixture(scope="module")
def transunet_f64_run(tmp_path_factory, transunet_run):
    out = tmp_path_factory.mktemp("transunet_tp4")
    spec = {**transunet_run["spec"], "mesh": (1, 4), "dtype": "float64"}
    return dict(spec=spec, results=_launch(spec, str(out)))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", ["plain", "dropout"])
def test_tensor_parallel_f64_step_equals_the_one_process_step(
        transunet_f64_run, run):
    """M = 4, one head and a quarter of each MLP a rank, dropout 0 and 0.1:
    in f64, where no rounding flips a ReLU, the loss and every parameter's
    SGD step equal the one-process f64 step's to 1e-9 of its peak (the
    sums of the row-parallel outputs and of the replicated gradients run
    in another order, nothing else)."""
    spec, results = transunet_f64_run["spec"], transunet_f64_run["results"]
    dropout = spec["dropout"] if run == "dropout" else 0.0
    loss, model = port_step(spec, dropout, dtype=torch.float64)
    ref = model.state_dict()
    for r in results:
        assert r[run]["loss"] == pytest.approx(loss, rel=1e-12, abs=0)
    ours = results[0][run]["state"]
    for name, _ in model.named_parameters():
        before = spec["state"][name]
        step, want = _step(ours[name], before), _step(ref[name], before)
        err = (step - want).abs().max().item()
        assert err <= 1e-9 * want.abs().max().item() + 1e-13, (name, err)


@pytest.fixture(scope="module")
def cltr_run(tmp_path_factory, mesh):
    import jax
    import jax.numpy as jnp

    from unet_torch_tpu.core.mesh import replicated_sharding, shard_batch
    from unet_torch_tpu.models import cltr as jc
    from unet_torch_tpu.train.cltr_steps import make_cltr_fused_step
    from unet_torch_tpu.train.optim import make_optimizer
    from unet_torch_tpu.train.state import TrainState
    from unet_torch_tpu_torch.ckpt.bridge import cltr_state_dict_from_flax
    from unet_torch_tpu_torch.models import cltr as pc

    out = tmp_path_factory.mktemp("cltr_dp")
    rng = np.random.RandomState(2)
    model = jc.ConditionalDETR(**CLTR)
    x = rng.randn(8, IMG_CLTR, IMG_CLTR, 3).astype(np.float32)
    variables = jax.tree_util.tree_map(np.array, model.init(
        jax.random.key(0), jnp.asarray(x[:1]), train=False))
    pe = variables["params"]["point_embed"]["layer2"]
    pe["kernel"] = (rng.randn(*pe["kernel"].shape) * 0.1).astype(np.float32)
    targets = []
    for n in (3, 0, 5, 1, 2, 4, 0, 6):
        pts = rng.rand(n, 3).astype(np.float32)
        targets.append({"labels": np.ones(n, np.int64), "points": pts,
                        "points_macher": pts})
    labels, points, _, valid = pc.pad_targets(targets, 8, 3)
    weights = pc.build_weight_dict(dec_layers=CLTR["dec_layers"])
    crit = jc.SetCriterion(num_classes=2, weight_dict=weights)
    tx = make_optimizer("SGD", LR, WD)
    state = jax.device_put(TrainState.create(
        jax.tree_util.tree_map(jnp.array, variables["params"]),
        jax.tree_util.tree_map(jnp.array, variables["batch_stats"]), tx),
        replicated_sharding(mesh))
    batch = shard_batch(mesh, tuple(jnp.asarray(a) for a in (
        x, labels, points, valid)))
    state, loss, _ = make_cltr_fused_step(model, crit, tx)(
        state, *batch, LR, jax.random.key(7))
    after = cltr_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params),
        variables["batch_stats"])
    spec = {"kind": "cltr", "mesh": (2, 1), "dropout": 0.1,
            "state": cltr_state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]),
            "x": x, "labels": labels, "points": points, "valid": valid,
            "batch": ("x", "labels", "points", "valid")}
    results = _launch(spec, str(out))
    return dict(spec=spec, results=results, loss=float(loss), after=after)


@pytest.mark.timeout(300)
def test_cltr_data_parallel_step_matches_jax_on_the_mesh(cltr_run):
    """Each rank matches its four images on the auction; the point count
    is the whole batch's (DETR's convention)."""
    r = cltr_run
    for res in r["results"]:
        np.testing.assert_allclose(res["plain"]["loss"], r["loss"],
                                   **TOL_JAX)
    ours = r["results"][0]["plain"]["state"]
    for name, ref in r["after"].items():
        np.testing.assert_allclose(ours[name].numpy(), ref.numpy(),
                                   err_msg=name, **TOL_JAX)


@pytest.mark.timeout(300)
def test_cltr_data_parallel_dropout_step_matches_one_process(cltr_run):
    _check_against_port("cltr", cltr_run["spec"], cltr_run["results"],
                        "dropout")


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind", ["unet", "transunet", "cltr"])
def test_parallel_step_matches_one_process_step(kind, unet_run,
                                                transunet_run, cltr_run):
    """Dropout 0: each case's multi-rank step against the port's
    one-process step, through the parameters' SGD steps, where a term of the
    loss or of a BatchNorm formed over the whole batch and off by the factor
    D would show."""
    run = {"unet": unet_run, "transunet": transunet_run,
           "cltr": cltr_run}[kind]
    _check_against_port(kind, run["spec"], run["results"], "plain")


def jax_vis_weights(params, stats, x):
    """The JAX TransUnet's sown attention probabilities, a numpy array a
    layer, and its logits."""
    import jax.numpy as jnp

    from unet_torch_tpu.models.transunet import CONFIGS as JAX_CONFIGS
    from unet_torch_tpu.models.transunet import VisionTransformer

    config = vit_config(JAX_CONFIGS)
    logits, inter = VisionTransformer(config, img_size=IMG_VIT, num_classes=3,
                                      vis=True).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False, mutable=["intermediates"])
    enc = inter["intermediates"]["transformer"]["encoder"]
    return [np.asarray(enc[f"encoderblock_{i}"]["attn"]["attn_weights"][0])
            for i in range(config.transformer.num_layers)], np.asarray(logits)


def one_process_vis(state, x):
    """The port's one-process vis=True eval forward: (attn_weights, logits)."""
    from unet_torch_tpu_torch.models.transunet.configs import CONFIGS
    from unet_torch_tpu_torch.models.transunet.vit import VisionTransformer

    model = VisionTransformer(vit_config(CONFIGS), IMG_VIT, 3, vis=True)
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(x))
    return model.attn_weights, logits


def check_vis(gathered, logits, state, x, params, stats):
    """A mesh's gathered attn_weights within 1e-5 of the one-process port's
    and within the eval bound of JAX's sown ones; its vis=True logits those
    of vis=False within 1e-4, as in one process, and JAX's."""
    ref, _ = one_process_vis(state, x)
    theirs, jax_logits = jax_vis_weights(params, stats, x)
    assert len(gathered) == len(ref) == len(theirs) == 2
    for ours, want, jax_w in zip(gathered, ref, theirs):
        assert ours.shape == want.shape == jax_w.shape
        np.testing.assert_allclose(ours.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(ours.numpy(), jax_w, atol=2e-4,
                                   rtol=1e-3)
    np.testing.assert_allclose(logits[True].numpy(), logits[False].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(logits[True].numpy(), jax_logits, atol=2e-4,
                               rtol=1e-3)


@pytest.fixture(scope="module")
def vis_run(tmp_path_factory):
    from unet_torch_tpu_torch.ckpt.bridge import (
        transunet_state_dict_from_flax,
    )

    rng = np.random.RandomState(3)
    _, x, _, params, stats = _jax_setup("transunet", 2, IMG_VIT, rng)
    state = transunet_state_dict_from_flax(params, stats)
    spec = {"kind": "vis", "mesh": (1, 2), "state": state, "x": x}
    results = _launch(spec, str(tmp_path_factory.mktemp("vis_tp")))
    return dict(results=results, state=state, x=x, params=params,
                stats=stats)


@pytest.mark.timeout(300)
def test_vis_on_a_tensor_mesh_keeps_every_head(vis_run):
    """(D, M) = (1, 2), two of the four heads a rank: every rank's
    attn_weights gather all four heads, one process's (B, heads, N, N),
    and its logits are whole."""
    r = vis_run
    for res in r["results"]:
        assert all(w.shape == (2, 4, 16, 16) for w in res["weights"])
        check_vis(res["gathered"], res["logits"], r["state"], r["x"],
                  r["params"], r["stats"])


@pytest.mark.parametrize("offsets", [(0, 0, 3), (2, 1, 3), (1, 2, 5)])
def test_keep_mask_with_offsets_is_the_slice_of_the_whole_mask(offsets):
    """A rank's mask (its rows from b_off, its heads from h_off of h_total)
    is, bit for bit, its slice of the one-process mask; so are the plain
    train forward's outputs."""
    from unet_torch_tpu_torch.kernels import attention as A

    b_off, h_off, h_total = offsets
    b, h, nq, nk = 2, 2, 24, 40
    whole = A._keep_mask(11, 0.3, (b_off + b, h_total, nq, nk), None,
                         "cpu")
    mine = A._keep_mask(11, 0.3, (b, h, nq, nk), None, "cpu", offsets)
    assert torch.equal(mine, whole[b_off:b_off + b, h_off:h_off + h])
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(b_off + b, h_total, n, 16)
                                .astype(np.float32)) for n in (nq, nk, nk))
    o_all, _ = A.attention_train_reference(q, k, v, 0.25, seed=11, rate=0.3)
    sl = (slice(b_off, b_off + b), slice(h_off, h_off + h))
    o, _ = A.attention_train_reference(q[sl].contiguous(),
                                       k[sl].contiguous(),
                                       v[sl].contiguous(), 0.25, seed=11,
                                       rate=0.3, offsets=offsets)
    assert torch.equal(o, o_all[sl])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
