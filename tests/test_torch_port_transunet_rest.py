"""The rest of the TransUnet family in the port against the JAX package, at
the small size of test_torch_port_transunet.py (hidden 16, 2 layers, 2
heads, ResNet (1, 1, 1), 64x64, as tests/test_transunet.py builds it): the
two-head and six-head models' bridge and eval forward, the `regression_t`
train step, the `multi_task_regTU` step under each combine, the `.npz`
loader bit for bit with the JAX one, `vis=True`, and the eval CLI for
`regression_t` and `multi_task_regTU`. On CPU tensors every kernel wrapper
runs its plain version."""

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
from unet_torch_tpu.models.transunet import \
    VisionTransformerMultitask as JaxViTMultitask
from unet_torch_tpu.models.transunet import \
    VisionTransformerMultitaskEM as JaxViTMultitaskEM
from unet_torch_tpu.models.transunet import build_transunet as jax_transunet
from unet_torch_tpu.models.transunet import load_npz_into_params
from unet_torch_tpu.train.optim import make_optimizer as jax_make_optimizer
from unet_torch_tpu.train.state import TrainState
from unet_torch_tpu.train.steps import _apply
from unet_torch_tpu.train.steps import make_single_steps as jax_steps
from unet_torch_tpu_torch.ckpt.bridge import transunet_state_dict_from_flax
from unet_torch_tpu_torch.models.transunet.configs import CONFIGS
from unet_torch_tpu_torch.models.transunet.npz import (
    load_npz_into_model,
    synthetic_npz_weights,
)
from unet_torch_tpu_torch.models.transunet.vit import (
    VisionTransformer,
    VisionTransformerMultitask,
    VisionTransformerMultitaskEM,
)
from unet_torch_tpu_torch.train.optim import make_optimizer
from unet_torch_tpu_torch.train.steps import make_single_steps

from test_torch_port_eval import (
    _compare_eval_clis,
    _config,
    _dataset,
    _jax_weights,
)
from test_torch_port_train_step import (
    LR,
    TOL,
    WD,
    _assert_step_matches,
    _bn_counts,
    _drawn,
    _no_dropout,
    multitask_case,
    multitask_step_matches_jax,
)
from test_torch_port_transunet import IMG, small_config

# the eval parity bound of the TransUnet (test_torch_port_transunet.py)
EVAL_TOL = dict(atol=2e-4, rtol=1e-3)

MULTIHEAD = {2: (JaxViTMultitask, VisionTransformerMultitask),
             6: (JaxViTMultitaskEM, VisionTransformerMultitaskEM)}
# the data seed of the two-head step (multitask_case): one whose train
# forward puts every decoder ReLU on the same side in JAX and in the port
# (decoder_relu_flips), with 2 torch threads and with the default; seeds 1
# to 6 flip 1 to 7 pixels of the 1.5 million
MULTITASK_SEED = 7


@pytest.fixture
def few_threads():
    """Two intra-op threads for the duration of a test: the suite runs in
    several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def decoder_relu_flips(model, params, batch_stats, x, port) -> int:
    """Pixels at which a decoder Conv2dReLU's ReLU falls on the other side
    of 0 in the JAX `model`'s train forward than in the port's (`port`
    holding the same weights; its BN buffers are left as they are).

    The two forwards differ by about 1e-5 of the activations' scale (XLA's
    and torch's f32 convs sum in other orders), so a pre-activation within
    that of 0 can flip. Through train-mode BN a flipped pixel moves every
    gradient upstream of its layer by up to its mse gradient, 2|o - y|/N,
    far beyond the step bound, while the loss and the logits still agree:
    the gradients are comparable element by element only without flips.
    (A flip is no fault of either side: the port's gradient there is its
    f64 gradient and its central difference.)"""
    _, state = model.apply({"params": params, "batch_stats": batch_stats},
                           jnp.asarray(x), train=True,
                           mutable=["batch_stats", "intermediates"],
                           capture_intermediates=lambda m, _: m.name == "bn")
    theirs = state["intermediates"]
    train_copy, ours = copy.deepcopy(port).train(), {}
    for name, m in train_copy.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d) and name.startswith("decoder"):
            m.register_forward_hook(
                lambda mod, inp, out, name=name: ours.__setitem__(
                    name, out.permute(0, 2, 3, 1).numpy()))
    with torch.no_grad():
        train_copy(torch.from_numpy(x))
    flips = 0
    for name, out in ours.items():
        decoder, rest = name.split(".", 1)
        tree = theirs[decoder]
        if rest.startswith("conv_more"):
            tree = tree["conv_more"]
        else:
            _, i, conv, _ = rest.split(".")
            tree = tree[f"block_{i}"][conv]
        # the JAX package's W-folded tail (B, H, W/f, f*C) unfolds by a
        # reshape
        ref = np.asarray(tree["bn"]["__call__"][0]).reshape(out.shape)
        flips += int(((ref > 0) != (out > 0)).sum())
    # every decoder's nine Conv2dReLUs
    assert len(ours) == 9 * sum(k.startswith("decoder") for k in theirs)
    return flips


@functools.cache
def _jax_multihead(n_heads, channels=3):
    """(JAX model, x, params, batch_stats, its logits): norm scales,
    biases, position embeddings and BN statistics drawn away from their
    init."""
    rng = np.random.RandomState(n_heads)
    x = rng.randn(2, IMG, IMG, channels).astype(np.float32)
    model = MULTIHEAD[n_heads][0](small_config(JAX_CONFIGS), img_size=IMG,
                                  num_classes=3)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(n_heads), jnp.asarray(x))
    params, batch_stats = _drawn(variables, rng)
    out = model.apply({"params": params, "batch_stats": batch_stats},
                      jnp.asarray(x), train=False)
    return model, x, params, batch_stats, [np.asarray(o) for o in out]


@pytest.mark.parametrize("n_heads,channels", [(2, 3), (6, 1)])
def test_multihead_eval_forward_matches_jax(n_heads, channels):
    """Every head's logits, the six-head model from a gray input (repeated
    to RGB as the single-head model does)."""
    _, x, params, batch_stats, ref = _jax_multihead(n_heads, channels)
    port = MULTIHEAD[n_heads][1](small_config(CONFIGS), IMG, 3)
    port.load_state_dict(transunet_state_dict_from_flax(params, batch_stats),
                         strict=True)
    port.eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert isinstance(out, tuple) and len(out) == len(ref) == n_heads
    for i, (ours, theirs) in enumerate(zip(out, ref)):
        assert ours.shape == (2, IMG, IMG, 3)
        np.testing.assert_allclose(ours.numpy(), theirs,
                                   err_msg=f"head {i + 1}", **EVAL_TOL)


@pytest.mark.parametrize("n_heads", [2, 6])
def test_multihead_bridge_is_the_single_head_bridge_per_head(n_heads):
    """Each head's tensors are what the single-head bridge (held by a round
    trip through the JAX package's load_torch_transunet) makes of that
    head's trees, renamed; together they cover the port's state_dict
    exactly. The uncertainty loop's {"model": ..., "log_vars": ...} adds
    `log_vars` and nothing else."""
    _, _, params, batch_stats, _ = _jax_multihead(n_heads)
    sd = transunet_state_dict_from_flax(params, batch_stats)
    port = MULTIHEAD[n_heads][1](small_config(CONFIGS), IMG, 3)
    assert set(sd) == set(port.state_dict())
    for i in range(1, n_heads + 1):
        single = transunet_state_dict_from_flax(
            {"transformer": params["transformer"],
             "decoder": params[f"decoder{i}"],
             "segmentation_head": params[f"segmentation_head{i}"]},
            {"transformer": batch_stats.get("transformer", {}),
             "decoder": batch_stats[f"decoder{i}"]})
        for name, tensor in single.items():
            for old, new in (("decoder.", f"decoder{i}."),
                             ("segmentation_head.", f"segmentation_head{i}.")):
                if name.startswith(old):
                    name = new + name[len(old):]
            assert torch.equal(sd[name], tensor), name
    log_vars = np.array([0.5, -0.25], np.float32)
    with_log_vars = transunet_state_dict_from_flax(
        {"model": params, "log_vars": log_vars}, batch_stats)
    assert set(with_log_vars) == set(sd) | {"log_vars"}
    np.testing.assert_array_equal(with_log_vars["log_vars"].numpy(), log_vars)
    if n_heads == 2:
        port.add_log_vars()
        port.load_state_dict(with_log_vars, strict=True)


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_regression_t_train_step_matches_jax(optimizer):
    """`regression_t`: the single-head step with ReLU on the one logit
    (make_single_steps(relu_output=True)) under `mse` on a density map,
    against the JAX step: the loss, every gradient, the parameters after
    the step and the BN running statistics, at the bounds of
    test_torch_port_train_step.py's TransUnet step. Dropout is 0 on both
    sides."""
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(3)
    x = rng.randn(2, IMG, IMG, 3).astype(np.float32)
    y = (rng.rand(2, IMG, IMG) * 2.0).astype(np.float32)
    model = JaxViT(_no_dropout(small_config(JAX_CONFIGS)), img_size=IMG,
                   num_classes=1)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(3), jnp.asarray(x))
    params, batch_stats = _drawn(variables, rng)
    jx, jy = jnp.asarray(x), jnp.asarray(y)

    def objective(p):
        out, _ = _apply(model, p, batch_stats, jx, train=True)
        return jax_calc_loss(jax.nn.relu(out), jy, loss_type="mse",
                             num_classes=1)

    jgrads = jax.tree_util.tree_map(np.asarray, jax.grad(objective)(params))
    lr = LR[optimizer]
    tx = jax_make_optimizer(optimizer, lr, WD)
    train_step, _ = jax_steps(model, tx, "mse", "mse", 1, relu_output=True)
    state = TrainState.create(params, batch_stats, tx)
    state, jloss = train_step(state, jx, jy, lr, jax.random.key(0))
    jafter = jax.tree_util.tree_map(np.asarray, state.params)
    jstats = jax.tree_util.tree_map(np.asarray, state.batch_stats)

    port = VisionTransformer(_no_dropout(small_config(CONFIGS)), IMG, 1)
    bridge = transunet_state_dict_from_flax
    before = bridge(params, batch_stats)
    port.load_state_dict(before, strict=True)
    assert decoder_relu_flips(model, params, batch_stats, x, port) == 0
    counts = _bn_counts(port, x)
    opt = make_optimizer(optimizer, port.parameters(), lr, WD)
    step, _ = make_single_steps("mse", "mse", 1, relu_output=True)
    loss = step(port, opt, torch.from_numpy(x), torch.from_numpy(y), lr,
                None)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    after = bridge(jafter, jstats)
    _assert_step_matches(port, optimizer, lr, WD, bridge(jgrads, batch_stats),
                         before, after)
    state_dict = port.state_dict()
    assert counts
    for prefix, n in counts.items():
        mean, var = f"{prefix}.running_mean", f"{prefix}.running_var"
        np.testing.assert_allclose(state_dict[mean].numpy(),
                                   after[mean].numpy(), err_msg=mean, **TOL)
        # torch's unbiased batch variance, the JAX package's biased one
        old = 0.9 * before[var].numpy()
        expect = old + (after[var].numpy() - old) * n / (n - 1)
        np.testing.assert_allclose(state_dict[var].numpy(), expect,
                                   err_msg=var, **TOL)


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("combine,use_ratio", [
    ("sum", False), ("uncertainty", False), ("ratio", True)])
def test_multi_task_regTU_train_step_matches_jax(combine, use_ratio):
    """`multi_task_regTU`: VisionTransformerMultitask with one class a head,
    one step of each combine (the uncertainty one with log_vars) against
    the JAX step, as test_torch_port_train_step.py holds UNetMultitask's,
    on data without ReLU flips (MULTITASK_SEED, decoder_relu_flips)."""
    model = JaxViTMultitask(_no_dropout(small_config(JAX_CONFIGS)),
                            img_size=IMG, num_classes=1)
    port = VisionTransformerMultitask(_no_dropout(small_config(CONFIGS)), IMG,
                                      1)
    x, _, _, params, batch_stats = multitask_case(model, MULTITASK_SEED)
    port.load_state_dict(transunet_state_dict_from_flax(params, batch_stats))
    assert decoder_relu_flips(model, params, batch_stats, x, port) == 0
    multitask_step_matches_jax(model, port, transunet_state_dict_from_flax,
                               combine, use_ratio, seed=MULTITASK_SEED)


@pytest.mark.parametrize("n_heads,n_positions", [
    (1, (IMG // 16) ** 2),  # the model's token count: copied
    (1, (IMG // 16) ** 2 + 1),  # a class token: dropped
    (1, 50),  # a 7 x 7 grid and a class token: re-gridded to 4 x 4
    (2, 50), (6, 17)])
def test_npz_loader_is_bit_exact_with_jax(n_heads, n_positions):
    """load_npz_into_model against transunet_state_dict_from_flax of the
    JAX package's load_npz_into_params on the same synthetic checkpoint of
    Google's layout, bit for bit, in the three position-embedding cases;
    the decoders and heads keep their weights."""
    jax_cls, port_cls = {1: (JaxViT, VisionTransformer),
                         **MULTIHEAD}[n_heads]
    port = port_cls(small_config(CONFIGS), IMG, 3,
                    generator=torch.Generator().manual_seed(0))
    weights = synthetic_npz_weights(port, 5, n_positions)
    jax_config = small_config(JAX_CONFIGS)
    model = jax_cls(jax_config, img_size=IMG, num_classes=3)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    ref = transunet_state_dict_from_flax(
        load_npz_into_params(variables["params"], weights, jax_config),
        variables["batch_stats"])
    before = {k: v.clone() for k, v in port.state_dict().items()}
    assert load_npz_into_model(port, weights) is port
    loaded = port.state_dict()
    n_transformer = 0
    for name, tensor in loaded.items():
        if name.startswith("transformer."):
            assert torch.equal(tensor, ref[name]), name
            n_transformer += 1
        else:
            assert torch.equal(tensor, before[name]), name
    assert n_transformer == sum(k.startswith("transformer.") for k in ref)
    with pytest.raises(ValueError, match="does not fit"):
        load_npz_into_model(port, {**weights, "embedding/bias": np.zeros(3)})


def test_vis_keeps_the_attention_weights_of_jax():
    """vis=True: after an eval forward `attn_weights` holds one
    (B, heads, N, N) tensor a layer, in order, whose rows sum to 1, equal to
    the JAX model's sowed intermediates within the eval bound; the logits
    are those of vis=False within 1e-4 and of JAX within the eval bound."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, IMG, IMG, 3).astype(np.float32)
    config = small_config(JAX_CONFIGS)
    variables = JaxViT(config, img_size=IMG, num_classes=3).init(
        jax.random.key(4), jnp.asarray(x), train=False)
    params, batch_stats = _drawn(variables, rng)
    ref, inter = JaxViT(config, img_size=IMG, num_classes=3, vis=True).apply(
        {"params": params, "batch_stats": batch_stats}, jnp.asarray(x),
        train=False, mutable=["intermediates"])
    enc = inter["intermediates"]["transformer"]["encoder"]
    n_layers = config.transformer.num_layers
    ref_weights = [np.asarray(
        enc[f"encoderblock_{i}"]["attn"]["attn_weights"][0])
        for i in range(n_layers)]

    sd = transunet_state_dict_from_flax(params, batch_stats)
    out = {}
    for vis in (True, False):
        port = VisionTransformer(small_config(CONFIGS), IMG, 3, vis=vis)
        port.load_state_dict(sd, strict=True)
        port.eval()
        with torch.inference_mode():
            out[vis] = port(torch.from_numpy(x)).numpy()
        if vis:
            weights = port.attn_weights
    n_tokens = (IMG // 16) ** 2
    assert len(weights) == n_layers
    for ours, theirs in zip(weights, ref_weights):
        assert ours.shape == (2, config.transformer.num_heads, n_tokens,
                              n_tokens) == theirs.shape
        assert ours.dtype == torch.float32 and not ours.requires_grad
        np.testing.assert_allclose(ours.sum(-1).numpy(), 1.0, atol=1e-5)
        np.testing.assert_allclose(ours.numpy(), theirs, **EVAL_TOL)
    np.testing.assert_allclose(out[True], out[False], atol=1e-4)
    np.testing.assert_allclose(out[True], np.asarray(ref), **EVAL_TOL)


@pytest.mark.usefixtures("few_threads")
def test_vis_trains_as_the_kernel_path():
    """A train step with vis=True runs the plain attention under autograd:
    at dropout 0 its loss and gradients are those of vis=False (the train
    kernels' plain versions on the CPU) within the step bound, and the
    weights it keeps are detached."""
    config = _no_dropout(small_config(CONFIGS))
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, IMG, IMG, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 3, (2, IMG, IMG)).astype(np.float32))
    base = VisionTransformer(config, IMG, 3,
                             generator=torch.Generator().manual_seed(6))
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", 3)
    results = {}
    for vis in (True, False):
        port = VisionTransformer(config, IMG, 3, vis=vis)
        port.load_state_dict(base.state_dict(), strict=True)
        opt = make_optimizer("SGD", port.parameters(), 0.01, WD)
        loss = step(port, opt, x, y, 0.01, None)
        results[vis] = (loss.item(), {n: p.grad for n, p in
                                      port.named_parameters()})
        if vis:
            assert all(not w.requires_grad for w in port.attn_weights)
    np.testing.assert_allclose(results[True][0], results[False][0], **TOL)
    for name, g in results[False][1].items():
        np.testing.assert_allclose(results[True][1][name].numpy(), g.numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("model_type,num_class", [
    ("regression_t", 2), ("multi_task_regTU", 1)])
def test_transunet_family_eval_cli_matches_jax(tmp_path, monkeypatch,
                                               model_type, num_class):
    """The eval CLI builds `regression_t` (mode `reg`) and
    `multi_task_regTU` (mode `mt_reg`) as the JAX CLI does, with the small
    config swapped into both registries: the density maps and the results
    agree as they do for the UNet family (test_torch_port_eval.py)."""
    monkeypatch.setitem(JAX_CONFIGS, "R50-ViT-B_16",
                        small_config(JAX_CONFIGS))
    monkeypatch.setitem(CONFIGS, "R50-ViT-B_16", small_config(CONFIGS))
    cfg = _config(_dataset(tmp_path / "d"), tmp_path / "run", model_type,
                  num_class=num_class)
    model = jax_transunet(model_type, img_size=IMG, n_channels=3,
                          num_classes=num_class)
    params, batch_stats = _jax_weights(model, 14)
    _compare_eval_clis(tmp_path, monkeypatch, cfg, params, batch_stats,
                       transunet_state_dict_from_flax(params, batch_stats),
                       mode="auto", accumulator="TwoChannelRegResults",
                       method="add", pred_args=(1, 2), rtol=1e-4)
