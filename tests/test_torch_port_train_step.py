"""One train step of the port (unet_torch_tpu_torch/train) against the JAX
package's make_single_steps, from the same bridged weights on the same
batch: the loss, every gradient, the parameters after an SGD and an Adam
step, and the BN running statistics; for the small TransUnet (both JAX
decoder tails) and UNet base 8. Also the repaired train-mode faults:
bf16 train mode, seeded dropout, the attention dropouts and the f32
residual stream; and the optimizer and checkpoint helpers. Then the two-head
step (sum, uncertainty with log_vars, ratio off and on) of UNetMultitask
against make_multitask_steps, and a HausdorffDTLoss step of the binary
UNet."""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_torch_tpu.losses import calc_loss as jax_calc_loss
from unet_torch_tpu.models.transunet import CONFIGS as JAX_CONFIGS
from unet_torch_tpu.models.transunet import VisionTransformer as JaxViT
from unet_torch_tpu.models.unet import UNet as JaxUNet
from unet_torch_tpu.models.unet import UNetMultitask as JaxUNetMultitask
from unet_torch_tpu.train.optim import make_optimizer as jax_make_optimizer
from unet_torch_tpu.train.state import TrainState
from unet_torch_tpu.train.steps import _apply
from unet_torch_tpu.train.steps import make_multitask_steps as jax_mt_steps
from unet_torch_tpu.train.steps import make_single_steps as jax_steps
from unet_torch_tpu_torch import ckpt
from unet_torch_tpu_torch.ckpt.bridge import (
    state_dict_from_flax,
    transunet_state_dict_from_flax,
)
from unet_torch_tpu_torch.models.transunet.configs import CONFIGS
from unet_torch_tpu_torch.models.transunet.vit import (
    Attention,
    VisionTransformer,
)
from unet_torch_tpu_torch.models.unet import UNet, UNetMultitask
from unet_torch_tpu_torch.nn.dropout import Dropout, set_dropout_generator
from unet_torch_tpu_torch.train.optim import (
    ReduceLROnPlateau,
    make_optimizer,
    poly_lr,
)
from unet_torch_tpu_torch.train.steps import (
    make_multitask_steps,
    make_single_steps,
)


@pytest.fixture
def few_threads():
    """Two intra-op threads for the duration of a test: the suite runs in
    several worker processes at once, and the small CPU models of these
    tests otherwise fight over the cores. Tests that do not ask for it keep
    the process's default."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

from test_torch_port_transunet import IMG, _seeded_stats, small_config

LR = {"SGD": 0.01, "Adam": 1e-3}
WD = 1e-4  # the configs' weight decay
# the bound of the eval parity tests (JAX against torch, f32)
TOL = dict(atol=1e-4, rtol=1e-3)


def _no_dropout(config):
    config.transformer.dropout_rate = 0.0
    config.transformer.attention_dropout_rate = 0.0
    return config


@functools.cache
def _jax_side(kind):
    """(JAX model, x, y, params, batch_stats, bridge, JAX gradients of the
    loss), computed once per kind: the JAX model's init and its gradient are
    jit-compiled, which costs seconds each. Norm scales, biases, position
    embeddings and BN statistics are drawn away from their init, as
    tests/test_torch_port_transunet.py draws them."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, IMG, IMG, 3).astype(np.float32)
    if kind.startswith("transunet"):
        last = int(kind[len("transunet"):])
        model = JaxViT(_no_dropout(small_config(JAX_CONFIGS, last)),
                       img_size=IMG, num_classes=3)
        bridge = transunet_state_dict_from_flax
    else:
        model = JaxUNet(3, 3, base=8)
        bridge = state_dict_from_flax
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(0), jnp.asarray(x))

    def draw(path, a):
        a = np.asarray(a)
        if path[-1].key == "scale":
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        if path[-1].key in ("bias", "position_embeddings"):
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(draw, variables["params"])
    batch_stats = _seeded_stats(rng, variables["batch_stats"])
    y = rng.randint(0, 3, x.shape[:3]).astype(np.float32)
    jx, jy = jnp.asarray(x), jnp.asarray(y)

    def objective(p):
        out, _ = _apply(model, p, batch_stats, jx, train=True)
        return jax_calc_loss(out, jy, loss_type="dice_bce_mc", num_classes=3)

    grads = jax.tree_util.tree_map(np.asarray,
                                   jax.jit(jax.grad(objective))(params))
    return model, x, y, params, batch_stats, bridge, grads


def _setup(kind):
    """(JAX model, port model with the same weights, x, y, params,
    batch_stats, bridge, JAX gradients)."""
    model, x, y, params, batch_stats, bridge, grads = _jax_side(kind)
    if kind.startswith("transunet"):
        last = int(kind[len("transunet"):])
        port = VisionTransformer(_no_dropout(small_config(CONFIGS, last)),
                                 IMG, 3)
    else:
        port = UNet(3, 3, base=8)
    port.load_state_dict(bridge(params, batch_stats), strict=True)
    return model, port, x, y, params, batch_stats, bridge, grads


def _bn_counts(port, x):
    """Elements per channel that each BatchNorm2d of the port averages in
    train mode, by state_dict prefix."""
    counts, hooks = {}, []
    for name, m in port.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: counts.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1])))
    port.train()
    with torch.no_grad():
        copy.deepcopy(port)(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    return counts


@pytest.mark.parametrize("kind,optimizer", [
    ("transunet16", "SGD"), ("transunet16", "Adam"), ("transunet24", "SGD"),
    ("unet", "SGD"), ("unet", "Adam")])
def test_train_step_matches_jax(kind, optimizer):
    """transunet16 is the JAX package's folded decoder tail (transunet.yml
    trains with fold: true), transunet24 its unfolded one. Dropout is 0 on
    both sides.

    Adam's first step moves each parameter by lr * g / (|g| + eps), about
    lr * sign(g): where the reference's decayed gradient lies within the
    gradient bound of 0 (the weight-standardised convs' gradients take the
    difference of nearly equal sums), either sign is right, and the check
    there is that the move stays within lr.

    Max pool ties: the JAX pool splits the gradient among tied maxima
    (nn/blocks.py:184-190), torch gives it to one. After ReLU the ties sit
    at 0, where ReLU's gradient is 0 in both, so the gradients stay
    comparable; on random inputs other ties do not occur."""
    torch.backends.cudnn.allow_tf32 = False
    model, port, x, y, params, batch_stats, bridge, jgrads = _setup(kind)
    counts = _bn_counts(port, x)
    lr = LR[optimizer]
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx = jax_make_optimizer(optimizer, lr, WD)
    train_step, _ = jax_steps(model, tx, "dice_bce_mc", "dice_bce_mc", 3)
    state = TrainState.create(params, batch_stats, tx)
    state, jloss = train_step(state, jx, jy, lr, jax.random.key(0))
    jparams = jax.tree_util.tree_map(np.asarray, state.params)
    jstats = jax.tree_util.tree_map(np.asarray, state.batch_stats)

    opt = make_optimizer(optimizer, port.parameters(), lr, WD)
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", 3)
    loss = step(port, opt, torch.from_numpy(x), torch.from_numpy(y), lr,
                None)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)

    ref_grads = bridge(jgrads, batch_stats)
    after = bridge(jparams, jstats)
    before = bridge(params, batch_stats)
    state_dict = port.state_dict()
    names = [n for n, _ in port.named_parameters()]
    assert names and set(names) <= set(ref_grads)
    for name, p in port.named_parameters():
        g = ref_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, err_msg=f"grad {name}",
                                   **TOL)
        ours, ref = p.detach().numpy(), after[name].numpy()
        if optimizer == "Adam":
            decayed = g + WD * before[name].numpy()
            free = np.abs(decayed) <= TOL["atol"] + TOL["rtol"] * np.abs(g)
            moved = np.abs(ours - before[name].numpy())
            assert (moved[free] <= lr * (1 + 1e-3)).all(), name
            ours, ref = ours[~free], ref[~free]
        np.testing.assert_allclose(ours, ref, err_msg=f"param {name}", **TOL)
    # BN: the same running mean; the running var with torch's unbiased
    # batch variance, the JAX package's biased one times n/(n-1)
    assert counts
    for prefix, n in counts.items():
        mean, var = f"{prefix}.running_mean", f"{prefix}.running_var"
        np.testing.assert_allclose(state_dict[mean].numpy(),
                                   after[mean].numpy(), err_msg=mean, **TOL)
        old = 0.9 * before[var].numpy()
        expect = old + (after[var].numpy() - old) * n / (n - 1)
        np.testing.assert_allclose(state_dict[var].numpy(), expect,
                                   err_msg=var, **TOL)


@pytest.mark.parametrize("kind", ["transunet16", "unet"])
def test_bf16_train_mode_runs(kind):
    """Fault 1: the train-mode convs take a bf16 input (their weights are
    cast to it); BN keeps f32 statistics; the gradients are f32."""
    _, port, x, y, *_ = _setup(kind)
    opt = make_optimizer("SGD", port.parameters(), 0.01, WD)
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", 3)
    loss = step(port, opt, torch.from_numpy(x).to(torch.bfloat16),
                torch.from_numpy(y), 0.01, None)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    for p in port.parameters():
        assert p.dtype == torch.float32 and torch.isfinite(p.grad).all()
    for m in port.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert m.running_var.dtype == torch.float32


def test_dropout_draws_from_the_generator():
    """Fault 2: the mask comes from the bound generator: the same seed gives
    the same mask, another seed another one, and 1 - p is kept."""
    drop = Dropout(0.3).train()
    x = torch.ones(64, 256)
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    outs = []
    for seed in (1, 1, 2):
        drop.generator = torch.Generator().manual_seed(seed)
        outs.append(drop(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    kept = (outs[0] != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.01
    np.testing.assert_allclose(outs[0][outs[0] != 0].numpy(), 1 / 0.7,
                               rtol=1e-6)
    assert torch.equal(drop.eval()(x), x)


def test_model_dropout_is_seeded_by_the_step_generator():
    """A TransUnet with its dropouts on: two steps from the same weights and
    generator seed give the same loss, another seed another loss."""
    config = small_config(CONFIGS)
    config.transformer.attention_dropout_rate = 0.2
    port = VisionTransformer(config, IMG, 3,
                             generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 3, (2, IMG, IMG),
                      generator=torch.Generator().manual_seed(2))
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", 3)
    losses = []
    for seed in (5, 5, 6):
        m = copy.deepcopy(port)
        opt = make_optimizer("SGD", m.parameters(), 0.01, WD)
        losses.append(step(m, opt, x, y, 0.01,
                           torch.Generator().manual_seed(seed)).item())
    assert losses[0] == losses[1] != losses[2]


def test_attention_has_both_dropouts():
    """Fault 3: at attention_dropout_rate > 0 the train-mode attention drops
    probabilities (its seed drawn from the generator) and the out
    projection's output; at rate 0, and in eval mode, neither."""
    att = Attention(16, 2, attention_dropout_rate=0.5)
    assert att.dropout.p == 0.5
    x = torch.randn(2, 10, 16, generator=torch.Generator().manual_seed(3))
    att.eval()
    with torch.no_grad():
        ref = att(x)
    att.train()
    outs = []
    for seed in (7, 7):
        set_dropout_generator(att, torch.Generator().manual_seed(seed))
        outs.append(att(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], ref)
    # the out projection's dropout zeroes whole output elements
    assert (outs[0] == 0).float().mean().item() > 0.3
    att0 = Attention(16, 2)
    att0.load_state_dict(att.state_dict())
    att0.train()
    np.testing.assert_allclose(att0(x).detach().numpy(), ref.numpy(),
                               atol=1e-6)


def test_residual_stream_is_f32_under_bf16():
    """Fault 4: under a bf16 input the ViT's residual stream is f32 (the
    f32 position embeddings promote it, as in the JAX model); the blocks'
    LayerNorm outputs and the encoder's output are bf16."""
    port = VisionTransformer(small_config(CONFIGS), IMG, 3)
    set_dropout_generator(port, torch.Generator().manual_seed(0))
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: seen.__setitem__(name, out))
        for name, m in port.named_modules()
        if name in ("transformer.embeddings", "transformer.encoder",
                    "transformer.encoder.layer.0",
                    "transformer.encoder.layer.1",
                    "transformer.encoder.layer.0.attention_norm")]
    for mode in (port.eval, port.train):
        mode()
        seen.clear()
        with torch.no_grad():
            out = port(torch.randn(2, IMG, IMG, 3).to(torch.bfloat16))
        assert seen["transformer.embeddings"][0].dtype == torch.float32
        assert seen["transformer.encoder.layer.0"].dtype == torch.float32
        assert seen["transformer.encoder.layer.1"].dtype == torch.float32
        assert seen["transformer.encoder"].dtype == torch.bfloat16
        assert out.dtype == torch.bfloat16
    for h in hooks:
        h.remove()


def test_optimizer_semantics_and_schedules():
    """L2 decay before the update (torch's SGD and Adam), clipping when
    asked, poly LR and the plateau scheduler as in the JAX package."""
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = make_optimizer("SGD", [w], 0.1, weight_decay=0.5)
    w.grad = torch.tensor([0.2, 0.2])
    opt.step()
    np.testing.assert_allclose(w.detach().numpy(),
                               [1.0 - 0.1 * 0.7, -2.0 - 0.1 * (0.2 - 1.0)],
                               rtol=1e-6)
    w2 = torch.nn.Parameter(torch.tensor([3.0, 4.0]))
    opt2 = make_optimizer("SGD", [w2], 1.0, clip_max_norm=1.0)
    w2.grad = torch.tensor([3.0, 4.0])
    step, _ = make_single_steps("CE", "CE", 2)
    from unet_torch_tpu_torch.train.optim import clip_gradients

    clip_gradients(opt2)
    np.testing.assert_allclose(w2.grad.numpy(), [0.6, 0.8], rtol=1e-5)
    with pytest.raises(ValueError):
        make_optimizer("RMSprop", [w], 0.1)
    assert poly_lr(0.01, 0, 100) == 0.01
    np.testing.assert_allclose(poly_lr(0.01, 50, 100), 0.01 * 0.5 ** 0.9)
    assert poly_lr(0.01, 200, 100) == 0.0
    plateau = ReduceLROnPlateau(1.0, patience=1)
    assert [plateau.step(m) for m in (1.0, 2.0, 2.0, 0.5)] == [1.0, 1.0, 0.5,
                                                               0.5]


def test_full_checkpoint_round_trip(tmp_path):
    """save_full / restore_full keep the weights, the optimizer's moments
    and the step."""
    port = UNet(3, 3, base=4, generator=torch.Generator().manual_seed(0))
    opt = make_optimizer("Adam", port.parameters(), 1e-3, WD)
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", 3)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 3, (2, 32, 32))
    step(port, opt, x, y, 1e-3, None)
    path = str(tmp_path / "full.pt")
    ckpt.save_full(path, port, opt, 7)
    fresh = UNet(3, 3, base=4)
    fresh_opt = make_optimizer("Adam", fresh.parameters(), 1e-3, WD)
    assert ckpt.restore_full(path, fresh, fresh_opt) == 7
    for a, b in zip(port.state_dict().values(), fresh.state_dict().values()):
        assert torch.equal(a, b)
    # the next step is the same on both
    la = step(port, opt, x, y, 1e-3, None).item()
    lb = step(fresh, fresh_opt, x, y, 1e-3, None).item()
    assert la == lb
    for a, b in zip(port.parameters(), fresh.parameters()):
        assert torch.equal(a, b)


def _drawn(variables, rng):
    """(params, batch_stats) as numpy, norm scales, biases, position
    embeddings and BN statistics drawn away from their init."""
    def draw(path, a):
        a = np.asarray(a)
        if path[-1].key == "scale":
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        if path[-1].key in ("bias", "position_embeddings"):
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        return a

    return (jax.tree_util.tree_map_with_path(draw, variables["params"]),
            _seeded_stats(rng, variables["batch_stats"]))


def _assert_step_matches(port, optimizer, lr, wd, ref_grads, before, after):
    """Every gradient and the parameters after the step, as
    test_train_step_matches_jax holds them (Adam: where the decayed gradient
    is within the gradient bound of 0 either sign is right, and the move
    stays within lr)."""
    for name, p in port.named_parameters():
        if name == "log_vars":
            continue
        g = ref_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, err_msg=f"grad {name}",
                                   **TOL)
        ours, ref = p.detach().numpy(), after[name].numpy()
        if optimizer == "Adam":
            decayed = g + wd * before[name].numpy()
            free = np.abs(decayed) <= TOL["atol"] + TOL["rtol"] * np.abs(g)
            moved = np.abs(ours - before[name].numpy())
            assert (moved[free] <= lr * (1 + 1e-3)).all(), name
            ours, ref = ours[~free], ref[~free]
        np.testing.assert_allclose(ours, ref, err_msg=f"param {name}", **TOL)


def multitask_case(model, seed=1):
    """(x, y1, y2, params, batch_stats) of a two-head step: a batch of 2
    64x64 images with density-map targets, and the JAX `model`'s trees
    drawn away from their init, all from `seed`."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    y1, y2 = (rng.rand(2, 64, 64).astype(np.float32) * s for s in (2.0, 3.0))
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(0), jnp.asarray(x))
    return (x, y1, y2, *_drawn(variables, rng))


def multitask_step_matches_jax(model, port, bridge, combine, use_ratio,
                               seed=1):
    """One two-head step of `port` against the JAX `model`'s
    make_multitask_steps from the same weights (multitask_case(model,
    seed)): the eval step, the combined loss, both head losses, every
    gradient and the parameters after it; for `uncertainty` also the
    log-variances, which ride the same Adam (5e-4, no weight decay, as the
    trainer sets it). `bridge` turns the JAX model's trees into the port's
    state_dict. fused_head is off on the JAX side (the port has no planes
    form)."""
    torch.backends.cudnn.allow_tf32 = False
    x, y1, y2, params, batch_stats = multitask_case(model, seed)
    log_vars = np.array([0.3, -0.2], np.float32)
    optimizer, lr, wd = (("Adam", 5e-4, 0.0) if combine == "uncertainty"
                         else ("SGD", 0.01, WD))

    tx = jax_make_optimizer(optimizer, lr, wd)
    train_step, eval_step = jax_mt_steps(model, tx, "mse", 1, combine=combine)
    jparams = ({"model": params, "log_vars": jnp.asarray(log_vars)}
               if combine == "uncertainty" else params)
    state = TrainState.create(jparams, batch_stats, tx)
    jargs = tuple(jnp.asarray(a) for a in (x, y1, y2))
    jflag = jnp.asarray(use_ratio)

    def objective(p):
        pm = p["model"] if combine == "uncertainty" else p
        (o1, o2), _ = _apply(model, pm, batch_stats, jargs[0], train=True)
        o1, o2 = jax.nn.relu(o1), jax.nn.relu(o2)
        l1 = jax_calc_loss(o1, jargs[1], loss_type="mse", num_classes=1)
        l2 = jax_calc_loss(o2, jargs[2], loss_type="mse", num_classes=1)
        if combine == "uncertainty":
            stds = jnp.exp(p["log_vars"]) ** 0.5
            c = 1.0 / (2.0 * stds ** 2)
            return (c[0] * l1 + jnp.log(stds[0]) + c[1] * l2
                    + jnp.log(stds[1]))
        if combine == "ratio" and use_ratio:
            s = [jnp.sum(a, axis=(1, 2)) for a in
                 (jargs[1], o1[..., 0], jargs[2], o2[..., 0])]
            acc = jnp.mean(jnp.abs(s[0] / (s[0] + s[2])
                                   - s[1] / (s[1] + s[3])))
            return (l1 + l2) * (1.0 + 10.0 * acc)
        return l1 + l2

    jgrads = jax.tree_util.tree_map(np.asarray, jax.grad(objective)(jparams))
    jeval = eval_step(state, *jargs, jflag)
    jobjective = float(objective(jparams))
    # the step donates its state: nothing of it is read after this line
    state, jloss, jl1, jl2 = train_step(state, *jargs, lr, jax.random.key(0),
                                        jflag)
    # the written-out objective above is the step's own
    np.testing.assert_allclose(jobjective, float(jloss), rtol=1e-6)
    jafter = jax.tree_util.tree_map(np.asarray, state.params)
    jstats = jax.tree_util.tree_map(np.asarray, state.batch_stats)

    port.load_state_dict(bridge(params, batch_stats), strict=True)
    if combine == "uncertainty":
        port.add_log_vars()
        with torch.no_grad():
            port.log_vars.copy_(torch.from_numpy(log_vars))
    opt = make_optimizer(optimizer, port.parameters(), lr, wd)
    step, port_eval = make_multitask_steps("mse", 1, combine=combine)
    targs = tuple(torch.from_numpy(a) for a in (x, y1, y2))
    flag = torch.tensor(use_ratio)
    eloss, el1, el2, eo1, eo2 = port_eval(port, *targs, flag)
    for ours, ref in zip((eloss, el1, el2, eo1, eo2), jeval):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    loss, l1, l2 = step(port, opt, *targs, lr, None, flag)
    for ours, ref in ((loss, jloss), (l1, jl1), (l2, jl2)):
        assert ours.dim() == 0 and not ours.requires_grad
        np.testing.assert_allclose(ours.item(), float(ref), **TOL)
    if combine == "ratio":
        assert (float(jloss) > float(jl1) + float(jl2) + 1e-3) == use_ratio

    model_of = (lambda p: p["model"]) if combine == "uncertainty" \
        else (lambda p: p)
    _assert_step_matches(port, optimizer, lr, wd,
                         bridge(model_of(jgrads), batch_stats),
                         bridge(params, batch_stats),
                         bridge(model_of(jafter), jstats))
    if combine == "uncertainty":
        np.testing.assert_allclose(port.log_vars.grad.numpy(),
                                   jgrads["log_vars"], **TOL)
        np.testing.assert_allclose(port.log_vars.detach().numpy(),
                                   jafter["log_vars"], **TOL)
        assert not np.array_equal(jafter["log_vars"], log_vars)


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("combine,use_ratio", [
    ("sum", False), ("uncertainty", False), ("ratio", False),
    ("ratio", True)])
def test_multitask_train_step_matches_jax(combine, use_ratio):
    """UNetMultitask base 8 (multitask_step_matches_jax)."""
    multitask_step_matches_jax(JaxUNetMultitask(3, 1, base=8, fold=False),
                               UNetMultitask(3, 1, base=8),
                               state_dict_from_flax, combine, use_ratio)


def test_multitask_steps_reject_an_unknown_combine_and_warn_on_fused_head():
    with pytest.raises(ValueError):
        make_multitask_steps("mse", 1, combine="product")
    with pytest.warns(UserWarning, match="fused_head"):
        make_multitask_steps("mse", 1, fused_head=True)
    # the topo keys run in every step factory, as in JAX; a trainer loop
    # name that is no calc_loss key raises KeyError
    make_multitask_steps("TopoLoss", 1)
    with pytest.raises(KeyError):
        make_multitask_steps("TopoLoss2", 1)


@pytest.mark.usefixtures("few_threads")
def test_hausdorff_dt_train_step_matches_jax():
    """One Adam step of the binary UNet (one logit channel) under
    HausdorffDTLoss, whose distance fields come from the min-plus products
    of the thresholded sigmoid: the loss, every gradient and the
    parameters. A logit within round-off of 0 would put its pixel on either
    side of the 0.5 threshold in the two frameworks, and the distance fields
    with it; the seed is one whose logits keep away from 0, and the test
    says so."""
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(6)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    yy, xx = np.mgrid[:64, :64]
    y = np.stack([((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r)
                  for cy, cx, r in ((20, 24, 9), (40, 30, 14))]).astype(
                      np.float32)
    model = JaxUNet(3, 1, base=8)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(0), jnp.asarray(x))
    params, batch_stats = _drawn(variables, rng)
    lr = 1e-3
    tx = jax_make_optimizer("Adam", lr, WD)
    train_step, _ = jax_steps(model, tx, "HausdorffDTLoss", "dice_bce", 1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)

    def objective(p):
        out, _ = _apply(model, p, batch_stats, jx, train=True)
        return jax_calc_loss(out, jy, loss_type="HausdorffDTLoss",
                             num_classes=1)

    jgrads = jax.tree_util.tree_map(np.asarray, jax.grad(objective)(params))
    logits, _ = _apply(model, params, batch_stats, jx, train=True)
    assert np.abs(np.asarray(logits)).min() > 1e-4
    state = TrainState.create(params, batch_stats, tx)
    state, jloss = train_step(state, jx, jy, lr, jax.random.key(0))
    jafter = jax.tree_util.tree_map(np.asarray, state.params)
    jstats = jax.tree_util.tree_map(np.asarray, state.batch_stats)

    port = UNet(3, 1, base=8)
    port.load_state_dict(state_dict_from_flax(params, batch_stats),
                         strict=True)
    opt = make_optimizer("Adam", port.parameters(), lr, WD)
    step, eval_step = make_single_steps("HausdorffDTLoss", "dice_bce", 1)
    loss = step(port, opt, torch.from_numpy(x), torch.from_numpy(y), lr, None)
    assert float(jloss) > 0
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    _assert_step_matches(port, "Adam", lr, WD,
                         state_dict_from_flax(jgrads, batch_stats),
                         state_dict_from_flax(params, batch_stats),
                         state_dict_from_flax(jafter, jstats))
    vloss, vscore, out = eval_step(port, torch.from_numpy(x),
                                   torch.from_numpy(y))
    assert torch.isfinite(vloss) and torch.isfinite(vscore)
    assert out.shape == (2, 64, 64, 1)
