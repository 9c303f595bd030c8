"""The port's topo warm-up loop (train/steps.py::make_topo_steps,
Trainer.single_train_wup) against the JAX package's make_topo_steps on the
CPU, from the same bridged weights on the same batches: one warm-up step and
one serial topo step for the global `TopoLoss` and the localized `TopoCount`
(the loss, every gradient, the parameters after Adam), `topo_eval`, a
depth-2 `TopoPipeline` over 1, 2 and 5 batches, the BN buffers bitwise
unchanged by the pairing forwards, and the loop end to end through the
port's train CLI for 7 epochs (5 warm-up, 2 topo).

The binary UNet base 8 at 32x32, batch 2, dropout off; weights, BN
statistics and batches drawn with numpy from a seed. The seeds are ones
whose bars do not tie: the pairing of the two frameworks' likelihoods is
equal (asserted), so that a difference in the loss is a fault, not a tie
broken the other way.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_torch_tpu.data.synthetic import write_synthetic_dataset
from unet_torch_tpu.losses import calc_loss as jax_calc_loss
from unet_torch_tpu.losses import topo as jax_topo
from unet_torch_tpu.models.unet import UNet as JaxUNet
from unet_torch_tpu.train.optim import make_optimizer as jax_make_optimizer
from unet_torch_tpu.train.state import TrainState
from unet_torch_tpu.train.steps import _apply
from unet_torch_tpu.train.steps import make_topo_steps as jax_topo_steps
from unet_torch_tpu_torch.ckpt.bridge import state_dict_from_flax
from unet_torch_tpu_torch.cli import train_cli
from unet_torch_tpu_torch.cli.config import Config
from unet_torch_tpu_torch.models.unet import UNet
from unet_torch_tpu_torch.train import trainer as port_trainer
from unet_torch_tpu_torch.train.optim import make_optimizer
from unet_torch_tpu_torch.train.steps import buffers_kept, make_topo_steps

from test_torch_port_train_step import TOL, WD, _assert_step_matches, _drawn

LR = 1e-3
SIZE = 32
# TopoCount's window: two by two windows of the 32x32 map
WINDOW = 16


@pytest.fixture
def few_threads():
    """Two intra-op threads for the duration of a test (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    rng = np.random.RandomState(100 + seed)
    x = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    y = np.zeros((2, SIZE, SIZE), np.float32)
    dot = np.zeros((2, SIZE, SIZE), np.float32)
    for i in range(2):
        for _ in range(3 + i):
            cy, cx = rng.randint(4, SIZE - 4, 2)
            y[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= 9] = 1.0
            dot[i, cy, cx] = 1.0
    return x, y, dot


@functools.cache
def _jax_init():
    model = JaxUNet(3, 1, base=8)
    x = _batch(0)[0]
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(0), jnp.asarray(x))
    params, batch_stats = _drawn(variables, np.random.RandomState(3))
    return model, params, batch_stats


def _setup(loss_type, optimizer="Adam"):
    """JAX model, steps and state; the port's model, optimizer and steps;
    from the same weights."""
    model, params, batch_stats = _jax_init()
    tx = jax_make_optimizer(optimizer, LR, WD)
    jsteps = jax_topo_steps(model, tx, loss_type, 1, window=WINDOW)
    state = TrainState.create(params, batch_stats, tx)
    port = UNet(3, 1, base=8)
    port.load_state_dict(state_dict_from_flax(params, batch_stats),
                         strict=True)
    opt = make_optimizer(optimizer, port.parameters(), LR, WD)
    steps = make_topo_steps(loss_type, 1, window=WINDOW)
    return model, jsteps, state, port, opt, steps


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _pooled(out):
    return np.asarray(out, np.float32)[..., 0]


def _jax_topo_grads(model, state, port, x, dot, localized):
    """The JAX topo step's gradient, from its own pieces: the pairing of
    the train-mode logits on the host, then the loss at those pixels. Also
    asserts that the port's train-mode logits pair alike (no tie)."""
    jx = jnp.asarray(x)
    out, _ = _apply(model, state.params, state.batch_stats, jx, train=True)
    with torch.no_grad(), buffers_kept(port):
        port_out = port.train()(torch.from_numpy(x)).numpy()
    liks = [1.0 / (1.0 + np.exp(-_pooled(o))) for o in (out, port_out)]
    if localized:
        counts = jax_topo.window_dot_counts(dot, WINDOW)
        pair = [jax_topo.compute_pairing_windows(m, counts, WINDOW, 8)
                for m in liks]
    else:
        kgt = dot.sum(axis=(1, 2)).astype(np.int64)
        pair = [jax_topo.compute_pairing(m, None, 64, kgt_override=kgt)
                for m in liks]
    for a, b in zip(*pair):
        np.testing.assert_array_equal(a, b)
    idx = [jnp.asarray(a) for a in pair[0]]

    def objective(p):
        o, _ = _apply(model, p, state.batch_stats, jx, train=True)
        if localized:
            return jax_topo.topocount_loss_from_pairing(o, *idx, 8)
        return jax_topo.topo_loss_from_pairing(o, *idx, 64)

    return _np_tree(jax.grad(objective)(state.params))


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("loss_type", ["TopoLoss", "TopoCount"])
def test_warm_and_topo_step_match_jax(loss_type):
    torch.backends.cudnn.allow_tf32 = False
    model, jsteps, state, port, opt, steps = _setup(loss_type)
    (jwarm, _), (jtopo, _), _ = jsteps
    (warm, _), (topo, _), _ = steps
    gen = torch.Generator().manual_seed(0)
    x, y, dot = _batch(1)
    jx, jy, jdot = (jnp.asarray(a) for a in (x, y, dot))

    # the warm-up step: dice_bce
    def warm_objective(p):
        out, _ = _apply(model, p, state.batch_stats, jx, train=True)
        return jax_calc_loss(out, jy, loss_type="dice_bce", num_classes=1)

    jgrads = _np_tree(jax.grad(warm_objective)(state.params))
    before = _np_tree(state.params)
    state, jloss = jwarm(state, jx, jy, jdot, LR, jax.random.key(1))
    loss = warm(port, opt, *_torch(x, y, dot), LR, gen)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    _assert_step_matches(
        port, "Adam", LR, WD, state_dict_from_flax(jgrads, state.batch_stats),
        state_dict_from_flax(before, state.batch_stats),
        state_dict_from_flax(_np_tree(state.params), state.batch_stats))

    # a serial topo step from the same starting weights (Adam's first step
    # again, which _assert_step_matches' sign rule is for), another batch
    model, jsteps, state, port, opt, steps = _setup(loss_type)
    (_, _), (jtopo, _), _ = jsteps
    (_, _), (topo, _), _ = steps
    x, y, dot = _batch(2)
    jgrads = _jax_topo_grads(model, state, port, x, dot,
                             loss_type == "TopoCount")
    before = _np_tree(state.params)
    state, jloss = jtopo(state, jnp.asarray(x), jnp.asarray(y),
                         jnp.asarray(dot), LR, jax.random.key(2))
    loss = topo(port, opt, *_torch(x, y, dot), LR, gen)
    assert float(jloss) > 0
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    _assert_step_matches(
        port, "Adam", LR, WD, state_dict_from_flax(jgrads, state.batch_stats),
        state_dict_from_flax(before, state.batch_stats),
        state_dict_from_flax(_np_tree(state.params), state.batch_stats))
    # the BN statistics: the grad forward's update alone, as JAX's
    ref = state_dict_from_flax(before, _np_tree(state.batch_stats))
    for name, value in port.state_dict().items():
        if name.endswith("running_mean"):
            np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                       err_msg=name, **TOL)


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("loss_type", ["TopoLoss", "TopoCount"])
def test_topo_eval_matches_jax(loss_type):
    _, jsteps, state, port, _, steps = _setup(loss_type)
    x, y, dot = _batch(3)
    jloss, jout = jsteps[1][1](state, jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(dot))
    buffers = copy.deepcopy(dict(port.named_buffers()))
    loss, out = steps[1][1](port, *_torch(x, y, dot))
    assert float(jloss) > 0
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for name, value in port.named_buffers():
        assert torch.equal(value, buffers[name]), name


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("n_batches", [1, 2, 5])
def test_pipeline_matches_jax(n_batches):
    """Depth 2: a batch's pairing comes from the parameters two updates
    older, each batch gets one update, flush drains the rest; the losses in
    order and the parameters after all of them. Under SGD: Adam moves a
    parameter whose gradient is within rounding of 0 by about lr either way
    (test_train_step_matches_jax's rule, which needs each step's reference
    gradient), SGD by lr times the gradient, so the parameters after
    several steps compare within the bound."""
    _, jsteps, state, port, opt, steps = _setup("TopoLoss", "SGD")
    jpipe, pipe = jsteps[2](), steps[2]()
    gen = torch.Generator().manual_seed(0)
    updates, step = [], opt.step
    opt.step = lambda: updates.append(step())
    jlosses, losses = [], []
    for k in range(n_batches):
        x, y, dot = _batch(10 + k)
        state, jloss = jpipe.step(state, jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(dot), LR, jax.random.key(k))
        loss = pipe.step(port, opt, *_torch(x, y, dot), LR, gen)
        assert (loss is None) == (jloss is None) == (k < 2)
        if loss is not None:
            jlosses.append(float(jloss))
            losses.append(loss.item())
    state, drained = jpipe.flush(state)
    jlosses += [float(v) for v in drained]
    losses += [v.item() for v in pipe.flush(port, opt, gen)]
    assert len(losses) == len(jlosses) == n_batches
    assert int(state.step) == n_batches
    assert len(updates) == n_batches
    np.testing.assert_allclose(losses, jlosses, **TOL)
    after = state_dict_from_flax(_np_tree(state.params),
                                 _np_tree(state.batch_stats))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("loss_type", ["TopoLoss", "TopoCount"])
def test_pairing_forward_leaves_the_bn_buffers_as_they_were(loss_type):
    """After a serial topo step the buffers are those of one train-mode
    forward (the grad forward's) from where they were: bit for bit, so the
    pairing forward changed nothing. A pipeline step that only pairs leaves
    them untouched."""
    *_, port, opt, steps = _setup(loss_type)
    serial = copy.deepcopy(port)
    serial_opt = make_optimizer("Adam", serial.parameters(), LR, WD)
    x, y, dot = _torch(*_batch(4))
    twin = copy.deepcopy(port).train()
    with torch.no_grad():
        twin(x)
    untouched = copy.deepcopy(dict(port.named_buffers()))
    pipe = steps[2]()
    gen = torch.Generator().manual_seed(0)
    assert pipe.step(port, opt, x, y, dot, LR, gen) is None
    for name, value in port.named_buffers():
        assert torch.equal(value, untouched[name]), name
    pipe.flush(port, opt, gen)
    steps[1][0](serial, serial_opt, x, y, dot, LR, gen)
    buffers = dict(serial.named_buffers())
    for name, value in twin.named_buffers():
        assert torch.equal(buffers[name], value), name


@pytest.mark.parametrize("name", sorted(port_trainer.TOPO_LOSS_NAMES))
def test_trainer_sends_topo_names_to_the_warm_up_loop(name, monkeypatch):
    """Every name of the reference trainer's warm-up dispatch, for each
    single-head model type."""
    calls = []
    monkeypatch.setattr(port_trainer.Trainer, "single_train_wup",
                        lambda self: calls.append(self.model_type))
    from unet_torch_tpu.train.trainer import TOPO_LOSS_NAMES

    assert port_trainer.TOPO_LOSS_NAMES == TOPO_LOSS_NAMES
    types = ["single", "attention", "TransUnet", "regression"]
    for model_type in types:
        trainer = port_trainer.Trainer.__new__(port_trainer.Trainer)
        trainer.model_type, trainer.loss_function = model_type, name
        trainer.train()
    assert calls == types


@pytest.mark.usefixtures("few_threads")
def test_topo_wup_cli_end_to_end(tmp_path):
    """configs/topo_wup.yml's loop through the port's CLI on synthetic cells
    with dot maps: 7 epochs, 5 warm-up and 2 topo (pipelined), a loss and an
    MRA score recorded for each, the checkpoints saved."""
    root = tmp_path / "d"
    for split, seed in (("train", 1), ("val", 2)):
        write_synthetic_dataset(str(root / split), n_images=2, size=48,
                                n_classes=2, seed=seed)
    cfg = Config.from_dict({
        "model_config": {
            "initial_filter_size": [4], "kernel": [3],
            "drop_out_rate": [0.2], "input_size": [48, 48], "channel": 3,
            "num_class": 1, "model_type": "single", "dropout": False,
            "anydepth": False,
        },
        "train_config": {
            "loss": "TopoLoss", "accuracy": "TopoLoss", "optimizer": "Adam",
            "lr_rate": [0.001], "adaptive_lr": False, "weight_decay": [0.0],
            "batch_size": [2], "epochs": 7, "early_stop": 50,
            "num_workers": 0, "seed": [5], "precision": "f32",
        },
        "dataset_config": {
            "train_path": [str(root / "train")],
            "val_path": [str(root / "val")],
            "test_path": [], "augmentation": False,
            "save_dir": str(tmp_path / "run"), "class_names": [],
        },
        "resume": {"flag": False, "path": "", "epoch": 1},
    })
    trainers, results = train_cli.run_training(cfg, device="cpu")
    tr = trainers[5]
    assert results == {}
    assert len(tr.train_loss_list) == 7 and len(tr.val_score_list) == 7
    assert np.isfinite(tr.train_loss_list + tr.val_loss_list
                       + tr.val_score_list).all()
    seed_dir = tmp_path / "run" / "run_seed5"
    log = (seed_dir / "logs.txt").read_text()
    assert "Epoch 7/7" in log and "saving best model" not in log
    assert (seed_dir / "models" / "last_epoch.pt").exists()
    assert not (seed_dir / "models" / "best.pt").exists()
