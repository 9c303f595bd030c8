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

import functools
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_port_spatial import launch, run_rank

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


# --------------------------------------------------------------------------
# the pytest side
# --------------------------------------------------------------------------

def _launch(spec, out):
    """Run the spec's ranks; returns their results in rank order."""
    return launch(os.path.abspath(__file__), spec, out)


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


# --------------------------------------------------------------------------
# chip_smoke.py's check of a multi-rank f32 step on the ranks' own branch
# --------------------------------------------------------------------------

@functools.cache
def _chip_smoke():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _branch_spec(kind):
    """A seeded small model's state and batch for port_step."""
    torch.manual_seed(7)
    rng = np.random.RandomState(7)
    img = IMG_VIT if kind == "transunet" else IMG_CLTR
    spec = {"kind": kind, "state": build_model(kind, 0.0).state_dict(),
            "x": rng.randn(2, img, img, 3).astype(np.float32)}
    if kind == "transunet":
        spec["y"] = rng.randint(0, 3, (2, img, img)).astype(np.float32)
        spec["batch"] = ("x", "y")
        return spec
    from unet_torch_tpu_torch.models import cltr as pc

    targets = []
    for n in (3, 5):
        pts = rng.rand(n, 3).astype(np.float32)
        targets.append({"labels": np.ones(n, np.int64), "points": pts,
                        "points_macher": pts})
    labels, points, _, valid = pc.pad_targets(targets, 8, 3)
    spec.update(labels=labels, points=points, valid=valid,
                batch=("x", "labels", "points", "valid"))
    return spec


@pytest.fixture(scope="module", params=["transunet", "cltr"])
def branch_steps(request):
    """A small model's one-process SGD step in f32 and f64 as
    chip_smoke.py's branch_reference runs it, with its ReLUs' and max
    pools' rounding; and the same steps forced onto their own choices."""
    from unet_torch_tpu_torch.kernels import attention as at

    cs = _chip_smoke()
    torch.set_num_threads(2)
    spec = _branch_spec(request.param)

    def step_fn(dtype):
        loss, model = port_step(spec, 0.0, None, dtype)
        return model, spec["state"], loss

    modules = cs.branch_modules(request.param)

    def reference(forced=None, rounding=False):
        return cs.branch_reference(at, step_fn, modules, forced, rounding)

    plain, rounding = reference(rounding=True)
    own = {"relu": [x > 0 for x in rounding["relu"][0]],
           "max_pool2d": rounding["max_pool2d"][3]}
    return dict(cs=cs, kind=request.param, reference=reference, plain=plain,
                rounding=rounding, own=own, forced=reference(own)[0])


def _grads_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _contiguous(choices):
    return {k: [c.clone(memory_format=torch.contiguous_format) for c in v]
            for k, v in choices.items()}


def test_a_step_forced_onto_its_own_choices_is_the_plain_step(branch_steps):
    """x * (x > 0) is the ReLU and the input at the max pool's own argmax
    is its output, forward and backward: the f32 step forced onto its own
    choices is the plain one, bit for bit (the forced f64 step takes the
    f32 forward's choices, which is the point of it); every call is named
    by its module (the TransUnet's decoder Conv2dReLUs; CLTR's backbone,
    with one max pool, and transformer), and every choice agrees with its
    own."""
    b = branch_steps
    relu, pool = b["rounding"]["relu"], b["rounding"]["max_pool2d"]
    assert relu[2] and len(relu[0]) == len(relu[1]) == len(relu[2])
    if b["kind"] == "transunet":
        assert all("decoder" in n for n in relu[2]) and not pool[0]
    else:
        assert pool[2] == ["backbone"] and pool[3][0].dtype == torch.int64
        assert any(n.startswith("transformer") for n in relu[2])
    # (a CLTR MLP takes f32 positions in the f64 step too: e = 0 there)
    assert all(0 <= err < 1e-3 for err in relu[1] + pool[1])
    assert sum(err > 0 for err in relu[1]) > len(relu[1]) // 2
    plain, forced = b["plain"], b["forced"]
    assert plain[0] == forced[0]
    for i in (1, 2):
        assert _grads_equal(plain[i], forced[i]), i
    band = b["cs"].choice_band("own", b["rounding"], b["own"])
    assert band["relu"][0] == band["max_pool2d"][0] == 0


def test_one_flipped_relu_follows_that_branch_s_f64_gradient(branch_steps):
    """One pre-activation of the first ReLU call put on the other side of
    zero: the forced f32 step is as near the forced f64 step as the plain
    f32 step is to the plain f64 one (T4's ratio under 10), and T4's ratio
    against the plain steps fails."""
    b = branch_steps
    cs = b["cs"]
    choices = _contiguous(b["own"])
    flat = b["rounding"]["relu"][0][0].abs().argmax()
    mask = choices["relu"][0].view(-1)
    mask[flat] = ~mask[flat]
    _, _, g32, _, g64 = b["reference"](choices)[0]
    plain = b["plain"]
    on_branch = cs.gradient_noise_ratio(g32, plain[2], g64)[0]
    against_plain = cs.gradient_noise_ratio(g32, plain[2], plain[4])[0]
    assert on_branch <= cs.T4_NOISE_RATIO < against_plain, (
        on_branch, against_plain)


def test_the_choice_band_admits_rounding_flips_and_raises_past_them(
        branch_steps):
    """A planted ReLU flip at |z| <= 10 e of its call is admitted (its
    |z| / e returned); one past 10 e raises, naming the module. So does a
    max pool's choice of another element, by the gap between the two."""
    b = branch_steps
    cs = b["cs"]
    kinds = ["relu"] + (["max_pool2d"] if b["kind"] == "cltr" else [])
    for kind in kinds:
        x32, e, names, own = b["rounding"][kind]
        for scale, admitted in ((9.5, True), (10.5, False)):
            x = [t.clone(memory_format=torch.contiguous_format) for t in x32]
            choices = _contiguous(b["own"])
            if kind == "relu":
                x[0].view(-1)[3] = scale * e[0]
                choices["relu"][0].view(-1)[3] = False
            else:
                # output (0, 0, 1, 1) reads rows 1-3, columns 1-3: its own
                # element gets a rival at scale * e below it
                taken = int(own[0][0, 0, 1, 1])
                width = x[0].shape[3]
                rival = next(r * width + c for r in (1, 2, 3)
                             for c in (1, 2, 3) if r * width + c != taken)
                plane = x[0][0, 0].view(-1)
                plane[rival] = plane[taken] - scale * e[0]
                choices["max_pool2d"][0][0, 0, 1, 1] = rival
            rounding = {**b["rounding"], kind: (x, e, names, own)}
            if admitted:
                band = cs.choice_band("planted", rounding, choices)
                assert band[kind][0] == 1
                assert band[kind][2] == pytest.approx(scale, rel=1e-2)
            else:
                with pytest.raises(AssertionError,
                                   match=rf"{kind} call 0 \({names[0]}\)"):
                    cs.choice_band("planted", rounding, choices)


def test_a_forced_ratio_over_ten_raises(branch_steps):
    """on_branch holds the ranks' gradients within T4's 10 of the forced
    steps: a gradient 11 times the one-process f32 error away raises, 9
    times passes."""
    b = branch_steps
    cs = b["cs"]
    loss, state, g32, before, g64 = b["forced"]
    name = max(g64, key=lambda k: g64[k].abs().max().item())
    err = max((g32[name] - g64[name]).abs().max().item(),
              1e-6 * g64[name].abs().max().item())
    for times, passes in ((9.0, True), (11.0, False)):
        grads = {k: v.float() for k, v in g64.items()}
        grads[name] = (g64[name] + times * err).float()
        ranks = {"loss": loss, "grads": grads, "state": state}
        args = ("planted", ranks, b["plain"], b["rounding"], b["own"],
                b["forced"], LR)
        if passes:
            got = cs.on_branch(*args, adam=False)
            assert got["forced"][1] <= cs.T4_NOISE_RATIO
        else:
            with pytest.raises(AssertionError, match="times the one-process"):
                cs.on_branch(*args, adam=False)


def test_strip_choices_map_to_the_whole_image_and_join():
    """A strip's max-pool argmax (its input with a halo row each side, as
    exchange_rows gives it) maps to the whole image's plane; forced onto
    those indices the pool gives the whole image's output, 0 at an index
    outside it. joined_choices puts the ranks' shares together along the
    dim a rank holds a share of, takes the first rank's replicated ones,
    and raises on a count of calls that differs from one process's."""
    import types

    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(1, 2, 8, 4, generator=gen)
    mod = types.SimpleNamespace(F=torch.nn.functional)
    whole, whole_index = torch.nn.functional.max_pool2d(
        x, 3, stride=2, padding=1, return_indices=True)
    ranks = []
    for m in range(2):
        halo = torch.zeros(1, 2, 6, 4)
        lo, hi = 4 * m - 1, 4 * m + 5
        halo[:, :, max(0, -lo):6 - max(0, hi - 8)] = x[:, :, max(lo, 0):
                                                        min(hi, 8)]
        choices, tap = cs.recorded_choices(
            strip=types.SimpleNamespace(m=m))
        with cs.branch_calls([mod], tap=tap):
            mod.F.relu(x[:, :, 4 * m:4 * (m + 1)] - 0.5)
            mod.F.max_pool2d(halo, 3, stride=2, padding=(0, 1))
        ranks.append(cs.unpacked(choices))
    rounding = {"relu": ([x - 0.5], [0.0], ["x"], [None]),
                "max_pool2d": ([x], [0.0], ["x"], [whole_index])}
    joined = cs.joined_choices(ranks, rounding)
    assert torch.equal(joined["relu"][0], x > 0.5)
    assert torch.equal(joined["max_pool2d"][0], whole_index)
    forced = joined["max_pool2d"][0].clone()
    forced[0, 0, 0, 0] = -3
    with cs.branch_calls([mod], forced={"max_pool2d": [forced]}):
        y = mod.F.max_pool2d(x, 3, stride=2, padding=1)
    assert y[0, 0, 0, 0] == 0
    y[0, 0, 0, 0] = whole[0, 0, 0, 0]
    assert torch.equal(y, whole)
    with pytest.raises(AssertionError, match="relu calls"):
        cs.joined_choices(ranks[:1] + [{**ranks[1], "relu": []}], rounding)


def test_matches_past_ties_raise():
    """same_matches admits another assignment of equal cost and raises on
    a dearer one."""
    cs = _chip_smoke()
    # (level, image, query, target) costs; two targets, queries 0-2
    costs = torch.tensor([[[[1.0, 2.0], [1.0, 2.0], [3.0, 0.5]]]])
    ref = torch.tensor([[[0, 2]]])
    assert cs.same_matches("tie", torch.tensor([[[1, 2]]]), ref,
                           costs)[0] == 1
    with pytest.raises(AssertionError, match="matched other queries"):
        cs.same_matches("dear", torch.tensor([[[2, 0]]]), ref, costs)

if __name__ == "__main__":
    run_rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
             sys.argv[4], lambda spec: _rank_case(spec, sys.argv[4]))
