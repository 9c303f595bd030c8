"""The port's CLTR train step, eval loss, loop and train CLI against the JAX
package's, on the CPU, at the size of tests/test_cltr.py (16 queries, hidden
32, 4 heads, one encoder and two decoder layers, FFN 64, 64x64 images) with a
(1, 1, 1, 1) ResNet. Inputs are made from a seed with numpy.

One Adam step (lr 1e-4, weight decay 1e-4, dropout 0) is held against both
forms of the JAX step, the fused one (auction on the device) and the
two-phase one (scipy on the host between two jit phases), for both of the
port's matchers: the loss, every gradient and the parameters after, within
atol 1e-4 / rtol 1e-3 (sums in other orders; the bound of the port's other
train-step tests). Adam's first step moves a parameter by about lr *
sign(g): where the decayed gradient lies within the gradient bound of 0
either sign is right, and the test there is that the move stays within lr."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_torch_tpu.kernels.auction import auction_lsap_batched
from unet_torch_tpu.models import cltr as jc
from unet_torch_tpu.train.cltr_steps import (
    make_cltr_eval_loss,
    make_cltr_fused_step,
    make_cltr_steps,
)
from unet_torch_tpu.train.optim import make_optimizer as jax_make_optimizer
from unet_torch_tpu.train.state import TrainState
from unet_torch_tpu_torch import ckpt
from unet_torch_tpu_torch.ckpt.bridge import cltr_state_dict_from_flax
from unet_torch_tpu_torch.data.synthetic import write_synthetic_dataset
from unet_torch_tpu_torch.models import cltr as pc
from unet_torch_tpu_torch.train import cltr_steps
from unet_torch_tpu_torch.train.optim import make_optimizer
from unet_torch_tpu_torch.train.trainer import Trainer

TOL = dict(atol=1e-4, rtol=1e-3)
LR, WD = 1e-4, 1e-4
TINY = dict(num_queries=16, hidden_dim=32, nheads=4, enc_layers=1,
            dec_layers=2, dim_feedforward=64, dropout_rate=0.0,
            backbone_layers=(1, 1, 1, 1))


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


# the config's widths (hidden 256, 8 heads, FFN 2048) at 300 queries and
# two encoder and two decoder layers: wide enough to show what Adam's first
# steps at lr 1e-4 do to the full-width model's loss
WIDE = dict(TINY, num_queries=300, hidden_dim=256, nheads=8, enc_layers=2,
            dim_feedforward=2048)


@pytest.fixture(scope="module")
def setup():
    return _setup(TINY)


def _setup(size):
    """The flax model with its variables as numpy, a batch of two images
    (three points, none) padded to 8 slots, and both criteria."""
    rng = np.random.RandomState(0)
    model = jc.ConditionalDETR(**size)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    variables = _np_tree(model.init(jax.random.key(0), jnp.asarray(x),
                                    train=False))
    # the zero-initialised point head would leave its inputs without gradient
    pe = variables["params"]["point_embed"]["layer2"]
    pe["kernel"] = (rng.randn(*pe["kernel"].shape) * 0.1).astype(np.float32)
    pts = rng.rand(3, 3).astype(np.float32)
    targets = [{"labels": np.ones(3, np.int64), "points": pts,
                "points_macher": pts},
               {"labels": np.ones(0, np.int64),
                "points": np.zeros((0, 3), np.float32),
                "points_macher": np.zeros((0, 3), np.float32)}]
    labels, points, _, valid = pc.pad_targets(targets, 8, 3)
    weights = pc.build_weight_dict(dec_layers=2)
    return dict(model=model, variables=variables, x=x, labels=labels,
                points=points, valid=valid, size=size,
                jcrit=jc.SetCriterion(num_classes=2, weight_dict=weights),
                pcrit=pc.SetCriterion(num_classes=2, weight_dict=weights))


def _port_model(variables, size=TINY):
    port = pc.ConditionalDETR(**size)
    port.load_state_dict(cltr_state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    return port


def _jax_state(variables, tx):
    # fresh copies: the JAX steps donate their state
    return TrainState.create(
        jax.tree_util.tree_map(jnp.array, variables["params"]),
        jax.tree_util.tree_map(jnp.array, variables["batch_stats"]), tx)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """The loss and the parameters after one step of both JAX step forms,
    the matches they used, and the gradients of that objective."""
    s = setup
    model, crit = s["model"], s["jcrit"]
    tx = jax_make_optimizer("Adam", LR, WD)
    jx, la, po, va = (jnp.asarray(s[k]) for k in ("x", "labels", "points",
                                                  "valid"))
    rng = jax.random.key(7)
    cost_step, update_step, _ = make_cltr_steps(model, crit, tx)
    state = _jax_state(s["variables"], tx)
    costs = cost_step(state, jx, la, po, va, rng)
    match = crit.hungarian(np.asarray(costs), s["valid"].sum(1))
    auction = np.asarray(auction_lsap_batched(
        costs, jnp.broadcast_to(va[None], (2,) + va.shape)))
    np.testing.assert_array_equal(auction, match)
    # the JAX level_losses loses a valid target on query 0 to its padded
    # slots (tests/test_torch_port_cltr.py); this batch has none there
    assert not ((match == 0) & s["valid"][None]).any()
    state, loss_two, _ = update_step(state, jx, la, po, va,
                                     jnp.asarray(match), LR, rng)
    after_two = _np_tree(state.params)
    fused = make_cltr_fused_step(model, crit, tx)
    state, loss_fused, _ = fused(_jax_state(s["variables"], tx), jx, la, po,
                                 va, LR, rng)
    after_fused = _np_tree(state.params)

    def objective(params):
        out = model.apply({"params": params,
                           "batch_stats": s["variables"]["batch_stats"]}, jx,
                          train=True, rngs={"dropout": rng})
        return crit.losses(out, la, po, va, jnp.asarray(match))[0]

    grads = _np_tree(jax.grad(objective)(
        jax.tree_util.tree_map(jnp.asarray, s["variables"]["params"])))
    return dict(match=match, grads=grads, two_phase=(float(loss_two),
                                                     after_two),
                fused=(float(loss_fused), after_fused))


def _state_dict(params, variables):
    return cltr_state_dict_from_flax(params, variables["batch_stats"])


@pytest.mark.parametrize("matcher", ["auction", "scipy"])
@pytest.mark.parametrize("jax_form", ["fused", "two_phase"])
def test_train_step_matches_jax(setup, jax_steps, matcher, jax_form):
    s = setup
    port = _port_model(s["variables"])
    before = {k: v.clone() for k, v in port.state_dict().items()}
    opt = make_optimizer("Adam", port.parameters(), LR, WD)
    batch = [torch.from_numpy(s[k]) for k in ("x", "labels", "points",
                                              "valid")]
    loss, loss_dict = cltr_steps.train_step(port, s["pcrit"], opt, *batch,
                                            LR, None, None, matcher)
    jloss, jafter = jax_steps[jax_form]
    np.testing.assert_allclose(loss.item(), jloss, **TOL)
    assert set(loss_dict) == {
        "loss_ce", "loss_point", "cardinality_error", "loss_ce_0",
        "loss_point_0", "cardinality_error_0"}
    ref_grads = _state_dict(jax_steps["grads"], s["variables"])
    after = _state_dict(jafter, s["variables"])
    n_moved = 0
    for name, p in port.named_parameters():
        g = ref_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, err_msg=f"grad {name}",
                                   **TOL)
        ours, ref = p.detach().numpy(), after[name].numpy()
        decayed = g + WD * before[name].numpy()
        free = np.abs(decayed) <= TOL["atol"] + TOL["rtol"] * np.abs(g)
        moved = np.abs(ours - before[name].numpy())
        assert (moved[free] <= LR * (1 + 1e-3)).all(), name
        np.testing.assert_allclose(ours[~free], ref[~free],
                                   err_msg=f"param {name}", **TOL)
        n_moved += int((~free).sum())
    assert n_moved > 1000  # the comparison of the parameters is not empty
    # the frozen-BN buffers did not move
    for name, b in port.named_buffers():
        assert torch.equal(b, before[name]), name


def _steps_against_jax(s, batches):
    """Consecutive Adam steps of the port and of `make_cltr_fused_step` from
    the same weights on `batches`; (port losses, JAX losses, port model,
    JAX parameters after as a state_dict)."""
    tx = jax_make_optimizer("Adam", LR, WD)
    fused = make_cltr_fused_step(s["model"], s["jcrit"], tx)
    state = _jax_state(s["variables"], tx)
    port = _port_model(s["variables"], s["size"])
    opt = make_optimizer("Adam", port.parameters(), LR, WD)
    jax_losses, losses = [], []
    for i, batch in enumerate(batches):
        tensors = [torch.from_numpy(a) for a in batch]
        port.train()
        with torch.no_grad():
            match = cltr_steps.match_targets(s["pcrit"], port(tensors[0]),
                                             *tensors[1:])
        # JAX's level_losses loses a valid target that sits on query 0
        assert not ((match == 0) & tensors[3][None]).any()
        state, jloss, _ = fused(state, *(jnp.asarray(a) for a in batch), LR,
                                jax.random.key(7 + i))
        loss, _ = cltr_steps.train_step(port, s["pcrit"], opt, *tensors, LR,
                                        None, None, "auction")
        jax_losses.append(float(jloss))
        losses.append(loss.item())
    return (losses, jax_losses, port,
            _state_dict(_np_tree(state.params), s["variables"]))


def test_three_steps_on_two_batches_match_jax(setup):
    """Three consecutive Adam steps on batches A, B, A (other images, other
    points) against `make_cltr_fused_step`, dropout 0: the loss of every step
    within atol 1e-4 / rtol 1e-3 and the parameters after the third within
    3 * lr = 3e-4 (Adam moves a parameter by about lr a step, to either side
    where its gradient is within rounding of 0; the trajectories may part by
    that much and no more)."""
    s = setup
    rng = np.random.RandomState(5)
    pts = rng.rand(5, 3).astype(np.float32)
    targets = [{"labels": np.ones(n, np.int64), "points": p,
                "points_macher": p} for n, p in ((2, pts[:2]), (3, pts[2:]))]
    labels_b, points_b, _, valid_b = pc.pad_targets(targets, 8, 3)
    batch_a = [s[k] for k in ("x", "labels", "points", "valid")]
    batch_b = [(2.0 * rng.randn(2, 64, 64, 3) + 0.5).astype(np.float32),
               labels_b, points_b, valid_b]
    losses, jax_losses, port, after = _steps_against_jax(
        s, (batch_a, batch_b, batch_a))
    np.testing.assert_allclose(losses, jax_losses, **TOL)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   atol=3 * LR, rtol=0, err_msg=name)


def test_second_step_jump_at_the_config_widths_is_jax_s_too():
    """At the config's widths (hidden 256, FFN 2048; 300 queries, 2 + 2
    layers) from random weights, Adam at the config's lr 1e-4 raises the
    loss of the second step on the same batch to about three times the
    first, and the third is below the first again. The JAX fused step does
    the same, step for step within rtol 1e-3: the jump that the full-width
    model shows on the card is the model's and the optimizer's, not a
    difference of the port."""
    s = _setup(WIDE)
    batch = [s[k] for k in ("x", "labels", "points", "valid")]
    losses, jax_losses, _, _ = _steps_against_jax(s, (batch,) * 3)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-3)
    for run in (losses, jax_losses):
        assert run[1] > 2 * run[0] and run[2] < run[0], run


def test_both_matchers_pick_the_jax_matches(setup, jax_steps):
    s = setup
    port = _port_model(s["variables"]).train()
    batch = [torch.from_numpy(s[k]) for k in ("labels", "points", "valid")]
    with torch.no_grad():
        out = port(torch.from_numpy(s["x"]))
    for matcher in cltr_steps.MATCHERS:
        match = cltr_steps.match_targets(s["pcrit"], out, *batch, matcher)
        assert match.dtype == torch.int64 and match.shape == (2, 2, 8)
        np.testing.assert_array_equal(match.numpy(), jax_steps["match"])
    with pytest.raises(ValueError, match="matcher"):
        cltr_steps.match_targets(s["pcrit"], out, *batch, "greedy")


def test_infer_step_and_eval_loss_match_jax(setup):
    s = setup
    port = _port_model(s["variables"])
    tx = jax_make_optimizer("Adam", LR, WD)
    state = _jax_state(s["variables"], tx)
    jx, la, po, va = (jnp.asarray(s[k]) for k in ("x", "labels", "points",
                                                  "valid"))
    batch = [torch.from_numpy(s[k]) for k in ("x", "labels", "points",
                                              "valid")]
    _, _, jax_infer = make_cltr_steps(s["model"], s["jcrit"], tx)
    jlogits, jpoints = jax_infer(state, jx)
    logits, points = cltr_steps.infer_step(port, batch[0])
    assert not port.training and not logits.requires_grad
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(points.numpy(), np.asarray(jpoints),
                               atol=2e-4, rtol=1e-3)
    jtotal, jlog = make_cltr_eval_loss(s["model"], s["jcrit"])(
        state, jx, la, po, va)
    for matcher in cltr_steps.MATCHERS:
        total, log = cltr_steps.eval_loss(port, s["pcrit"], *batch, matcher)
        np.testing.assert_allclose(total.item(), float(jtotal), **TOL)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=2e-4,
                                   rtol=1e-3)


def test_train_step_with_dropout_is_reproducible_from_its_seeds(setup):
    """With dropout 0.1 the step draws its masks from `generator` and its
    attention seeds from `seed_generator`: the same two seeds give the same
    loss and parameters, another seed gives another loss."""
    s = setup
    batch = [torch.from_numpy(s[k]) for k in ("x", "labels", "points",
                                              "valid")]

    def run(seed):
        port = pc.ConditionalDETR(**{**TINY, "dropout_rate": 0.1})
        port.load_state_dict(_port_model(s["variables"]).state_dict())
        opt = make_optimizer("Adam", port.parameters(), LR, WD,
                             clip_max_norm=0.1)
        loss, _ = cltr_steps.train_step(
            port, s["pcrit"], opt, *batch, LR,
            torch.Generator().manual_seed(seed),
            torch.Generator().manual_seed(seed + 1))
        return loss.item(), port.state_dict()

    (l1, sd1), (l2, sd2), (l3, _) = run(3), run(3), run(4)
    assert l1 == l2 and all(torch.equal(sd1[k], sd2[k]) for k in sd1)
    assert l1 != l3 and np.isfinite([l1, l3]).all()


def _loaders(rng, n_train=2, batch=2):
    def targets(n):
        pts = rng.rand(n, 3).astype(np.float32)
        return {"labels": np.ones(n, np.int64), "points": pts,
                "points_macher": pts}

    train = [(rng.randn(batch, 64, 64, 3).astype(np.float32),
              [targets(int(rng.randint(0, 5))) for _ in range(batch)])
             for _ in range(n_train)]
    val = [(rng.randn(4, 64, 64, 3).astype(np.float32),
            (rng.rand(4, 64, 64) > 0.999).astype(np.float32))
           for _ in range(2)]
    return {"train": train, "val": val}


@pytest.mark.parametrize("fused", [True, False])
def test_cltr_loop_through_trainer(tmp_path, fused):
    """Trainer.train() dispatches CLTR to the loop: losses, val MAE / MRE,
    checkpoints; best.pt reloads strictly. Both matchers; with the scipy one
    also gradient clipping."""
    gen = torch.Generator().manual_seed(0)
    kw = {"num_queries": 8, "hidden_dim": 32, "nheads": 4, "enc_layers": 1,
          "dec_layers": 2, "dim_feedforward": 64, "dropout": 0.1,
          "backbone_layers": [1, 1, 1, 1]}
    model, criterion, _ = pc.build_cltr(kw, gen)
    trainer = Trainer(model, "CLTR", str(tmp_path), _loaders(
        np.random.RandomState(1)), 2, "Adam", LR, WD, patience=5,
        num_epochs=2, loss_function="cltr", accuracy_metric="cltr",
        num_classes=2, seed=3, device="cpu")
    trainer.cltr_fused_matcher = fused
    if not fused:
        trainer.cltr_clip_max_norm = 0.1
    else:
        trainer.criterion = criterion
    trainer.train()
    assert len(trainer.train_loss_list) == 2
    assert len(trainer.val_loss_list) == len(trainer.val_score_list) == 2
    assert np.isfinite(trainer.train_loss_list + trainer.val_loss_list).all()
    assert trainer.iter_num == 4 and trainer.criterion is not None
    for name in ("best.pt", "last_epoch.pt"):
        assert (tmp_path / "models" / name).exists()
    log = (tmp_path / "logs.txt").read_text()
    assert "Val score on epoch 2" in log
    fresh = ckpt.load_weights(str(tmp_path / "models" / "best.pt"),
                              pc.build_cltr(kw)[0])
    assert all(torch.equal(a, b) for a, b in zip(
        fresh.state_dict().values(), trainer.model.state_dict().values()))


_CLI_CLTR = {
    "num_queries": 8, "hidden_dim": 32, "nheads": 4, "enc_layers": 1,
    "dec_layers": 2, "dim_feedforward": 64, "dropout": 0.0,
    "crop_size": 32, "num_knn": 4, "dot_shape": [64, 64],
    "clip_max_norm": 0.1}


def _cli_cfg(tmp_path, cltr_config, resume=None):
    """The tiny config of tests/test_cltr_cli.py over two synthetic PNGs
    with their TSV annotations (written once per tmp_path)."""
    from unet_torch_tpu_torch.cli.config import Config

    img_dir, tsv_dir = str(tmp_path / "imgs"), str(tmp_path / "tsv")
    if not os.path.exists(img_dir):
        gen = str(tmp_path / "gen")
        write_synthetic_dataset(gen, n_images=2, size=64, n_classes=3, seed=3)
        os.makedirs(img_dir)
        os.makedirs(tsv_dir)
        for i in range(2):
            shutil.copy(f"{gen}/img{i}.png", f"{img_dir}/img{i}.png")
            shutil.copy(f"{gen}/img{i}.tsv", f"{tsv_dir}/img{i}.tsv")
    return Config.from_dict({
        "model_config": {
            "initial_filter_size": [8], "kernel": [3], "drop_out_rate": [0.1],
            "input_size": [64, 64], "channel": 3, "num_class": 2,
            "model_type": "CLTR", "dropout": False, "anydepth": False,
        },
        "train_config": {
            "loss": "cltr", "accuracy": "cltr", "optimizer": "Adam",
            "lr_rate": [0.0001], "adaptive_lr": False, "weight_decay": [0.0],
            "batch_size": [2], "epochs": 1, "early_stop": 20,
            "num_workers": 0, "seed": [2], "use_cuda": False,
        },
        "dataset_config": {
            "train_path": [img_dir], "val_path": [img_dir], "test_path": [],
            "dot_annotation_path": tsv_dir + "/",
            "augmentation": False, "save_dir": str(tmp_path / "run"),
            "class_names": [],
        },
        "resume": resume or {"flag": False, "path": "", "epoch": 1},
        "cltr_config": cltr_config,
    })


def test_cltr_train_cli_end_to_end(tmp_path):
    """The train CLI on the tiny config of tests/test_cltr_cli.py: datasets
    from PNGs and TSVs, the CLTR loop, checkpoints."""
    from unet_torch_tpu_torch.cli.train_cli import run_training

    trainers, results = run_training(_cli_cfg(tmp_path, _CLI_CLTR),
                                     device="cpu")
    tr = trainers[2]
    assert results == {}
    assert len(tr.train_loss_list) == 1 and len(tr.val_loss_list) == 1
    assert np.isfinite(tr.train_loss_list).all()
    assert tr.cltr_clip_max_norm == 0.1 and tr.model.num_queries == 8
    models = tmp_path / "run" / "run_seed2" / "models"
    assert (models / "last_epoch.pt").exists()
    assert (tmp_path / "run" / "config.json").exists()
    ckpt.load_weights(str(models / "last_epoch.pt"),
                      pc.build_cltr(_CLI_CLTR)[0])


def test_cltr_cli_pretrained_backbone_then_resume(tmp_path, capsys):
    """`pretrained_resnet50` (a torchvision-layout state_dict from
    torch.save, with its classifier) goes into a fresh model's backbone
    before the first step; a resumed run whose config still names it keeps
    the checkpoint's trained backbone."""
    from unet_torch_tpu_torch.cli.train_cli import run_training

    donor = pc.build_cltr(_CLI_CLTR, torch.Generator().manual_seed(9))[0]
    with torch.no_grad():
        donor.backbone.bn1.running_var.uniform_(0.5, 1.5)
    donor_sd = {k: v.clone() for k, v in donor.backbone.state_dict().items()}
    torch.save({**donor_sd, "fc.weight": torch.zeros(10, 2048)},
               tmp_path / "resnet50.pt")
    cltr_config = {**_CLI_CLTR,
                   "pretrained_resnet50": str(tmp_path / "resnet50.pt")}
    trainers, _ = run_training(_cli_cfg(tmp_path, cltr_config), device="cpu")
    assert "loaded pretrained resnet50" in capsys.readouterr().out
    trained = {k: v.clone()
               for k, v in trainers[2].model.backbone.state_dict().items()}
    # the frozen-BN buffers are the donor's, the weights have moved from it
    assert torch.equal(trained["bn1.running_var"], donor_sd["bn1.running_var"])
    assert not torch.equal(trained["conv1.weight"], donor_sd["conv1.weight"])
    assert (trained["conv1.weight"] - donor_sd["conv1.weight"]).abs().max() \
        <= 2 * 1.001e-4  # two Adam steps at lr 1e-4
    last = tmp_path / "run" / "run_seed2" / "models" / "last_epoch.pt"
    # resumed after its only epoch: no further step, the model as loaded
    trainers, _ = run_training(_cli_cfg(tmp_path, cltr_config, {
        "flag": True, "path": str(last), "epoch": 2}), device="cpu")
    resumed = trainers[2].model.backbone.state_dict()
    assert trainers[2].train_loss_list == []
    for k, v in resumed.items():
        assert torch.equal(v, trained[k]), k
