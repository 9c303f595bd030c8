"""The rest of the port's UNet family (UNetMultitask, UNetAttention,
AttentionGate) against the JAX package's: the weights bridges, the eval
forwards on the CPU, the factory and the checkpoint payload dispatch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_torch_tpu.ckpt.torch_import import (
    load_torch_unet,
    load_torch_unet_attention,
)
from unet_torch_tpu.models.unet import UNetAttention as JaxUNetAttention
from unet_torch_tpu.models.unet import UNetMultitask as JaxUNetMultitask
from unet_torch_tpu.nn.blocks import AttentionGate as JaxAttentionGate
from unet_torch_tpu_torch import ckpt
from unet_torch_tpu_torch.ckpt.bridge import (
    _bn,
    _conv,
    _conv_t,
    _tensor,
    attention_state_dict_from_flax,
    state_dict_from_flax,
)
from unet_torch_tpu_torch.kernels import fused_conv
from unet_torch_tpu_torch.models.unet import (
    UNetAttention,
    UNetMultitask,
    build_model,
)
from unet_torch_tpu_torch.nn.blocks import AttentionGate


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the duration of a test: the suite runs in
    several worker processes at once, and the small CPU models of these
    tests otherwise fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the bound of tests/test_torch_port_unet.py (JAX against torch, f32)
TOL = dict(atol=2e-4, rtol=1e-3)


def _seeded(variables, rng):
    """numpy trees with seeded BN running statistics: with the default mean
    0 / var 1 the BN of eval mode is trivial."""
    params = jax.tree_util.tree_map(np.asarray, variables["params"])

    def stat(path, a):
        if path[-1].key == "var":
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        return (rng.randn(*a.shape) * 0.1).astype(np.float32)

    batch_stats = jax.tree_util.tree_map_with_path(
        stat, jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    return params, batch_stats


def _jax_model(cls, hw, n_classes, seed=0, **kw):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *hw, 3).astype(np.float32)
    model = cls(3, n_classes, base=8, **kw)
    variables = model.init(jax.random.key(seed), jnp.asarray(x), train=False)
    return (model, x, *_seeded(variables, rng))


def _assert_trees_equal(ours, ref):
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)


def _zeros(tree):
    return jax.tree_util.tree_map(np.zeros_like, tree)


def test_multitask_bridge_roundtrips_through_load_torch_unet():
    _, _, params, batch_stats = _jax_model(JaxUNetMultitask, (32, 32), 1)
    sd = state_dict_from_flax(params, batch_stats)
    p2, b2 = load_torch_unet(sd, _zeros(params), _zeros(batch_stats),
                             heads=("_decod1", "_decod2"))
    _assert_trees_equal(p2, params)
    _assert_trees_equal(b2, batch_stats)
    # the reference's names are the port's: a strict load takes every key
    UNetMultitask(3, 1, base=8).load_state_dict(sd, strict=True)
    assert "up1_decod2.conv.double_conv.0.weight" in sd
    assert "outc_decod1.conv.bias" in sd


def test_attention_bridge_roundtrips_through_load_torch_unet_attention():
    _, _, params, batch_stats = _jax_model(JaxUNetAttention, (32, 32), 3)
    sd = attention_state_dict_from_flax(params, batch_stats)
    p2, b2 = load_torch_unet_attention(sd, _zeros(params),
                                       _zeros(batch_stats))
    _assert_trees_equal(p2, params)
    _assert_trees_equal(b2, batch_stats)
    UNetAttention(3, 3, base=8).load_state_dict(sd, strict=True)
    assert "attenion4.W_q.0.weight" in sd and "attenion1.psi.1.bias" in sd


@pytest.mark.parametrize("fold,hw", [(False, (64, 64)), (True, (64, 64)),
                                     (False, (60, 52))])
def test_multitask_eval_forward_matches_jax(fold, hw):
    """fold=True is the JAX package's default layout (same param trees);
    60x52 pools to odd sizes."""
    model, x, params, batch_stats = _jax_model(JaxUNetMultitask, hw, 1,
                                               fold=fold)
    ref = model.apply({"params": params, "batch_stats": batch_stats},
                      jnp.asarray(x), train=False)
    port = UNetMultitask(3, 1, base=8)
    port.load_state_dict(state_dict_from_flax(params, batch_stats),
                         strict=True)
    port.eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert len(out) == 2
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    assert not np.allclose(out[0].numpy(), out[1].numpy())


@pytest.mark.parametrize("hw", [(64, 64), (32, 48)])
def test_attention_eval_forward_matches_jax(hw):
    """The gates add the upsampled gating feature to the skip, so the sizes
    are multiples of 16 (the JAX model takes no others)."""
    model, x, params, batch_stats = _jax_model(JaxUNetAttention, hw, 3)
    ref = np.asarray(model.apply({"params": params,
                                  "batch_stats": batch_stats},
                                 jnp.asarray(x), train=False))
    port = UNetAttention(3, 3, base=8)
    port.load_state_dict(attention_state_dict_from_flax(params, batch_stats),
                         strict=True)
    port.eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_attention_gate_matches_jax(train):
    """One gate alone, eval (running statistics) and train (batch
    statistics, and the running ones after the step: torch's unbiased
    variance is JAX's biased one times n / (n - 1))."""
    rng = np.random.RandomState(1)
    q = rng.randn(2, 6, 5, 16).astype(np.float32)
    x = rng.randn(2, 12, 10, 8).astype(np.float32)
    gate = JaxAttentionGate(4)
    variables = gate.init(jax.random.key(0), jnp.asarray(q), jnp.asarray(x))
    params, batch_stats = _seeded(variables, rng)
    port = AttentionGate(16, 8, 4)
    sd = {"up.weight": _conv_t(params["ConvTranspose_0"]["kernel"]),
          "up.bias": _tensor(params["ConvTranspose_0"]["bias"])}
    for proj in ("W_q", "W_x", "psi"):
        sd[f"{proj}.0.weight"] = _conv(params[f"{proj}_conv"]["kernel"])
        sd[f"{proj}.0.bias"] = _tensor(params[f"{proj}_conv"]["bias"])
        _bn(sd, f"{proj}.1", params[f"{proj}_bn"], batch_stats[f"{proj}_bn"])
    port.load_state_dict(sd, strict=True)
    port.train(train)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    with torch.no_grad():
        out = port(nchw(q), nchw(x)).permute(0, 2, 3, 1).numpy()
    variables = {"params": params, "batch_stats": batch_stats}
    if train:
        ref, mut = gate.apply(variables, jnp.asarray(q), jnp.asarray(x),
                              train=True, mutable=["batch_stats"])
        n = 2 * 12 * 10
        for proj in ("W_q", "W_x", "psi"):
            new = mut["batch_stats"][f"{proj}_bn"]
            old = batch_stats[f"{proj}_bn"]
            bn = getattr(port, proj)[1]
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(new["mean"]), atol=1e-6)
            # JAX: 0.9 old + 0.1 biased; torch: 0.9 old + 0.1 unbiased
            biased = (np.asarray(new["var"]) - 0.9 * old["var"]) / 0.1
            np.testing.assert_allclose(
                bn.running_var.numpy(),
                0.9 * old["var"] + 0.1 * biased * n / (n - 1), rtol=1e-5)
    else:
        ref = gate.apply(variables, jnp.asarray(q), jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("model_type,cls,launches", [
    ("multi_task", UNetMultitask, 26), ("multi_task_reg", UNetMultitask, 26),
    ("attention", UNetAttention, 18)])
def test_build_model_builds_the_family(model_type, cls, launches,
                                       monkeypatch):
    """The factory's types, and every eval-mode conv3x3+BN+ReLU pair through
    the fused-conv wrapper: 10 in the encoder, 8 in each decoder."""
    model = build_model(model_type, n_channels=3, n_classes=1, base=4)
    assert isinstance(model, cls)
    calls = []
    from unet_torch_tpu_torch.nn import blocks

    def counting(*args):
        calls.append(1)
        return fused_conv.fused_conv3x3_bn_relu(*args)

    monkeypatch.setattr(blocks, "fused_conv3x3_bn_relu", counting)
    model.eval()
    with torch.inference_mode():
        model(torch.zeros(1, 32, 32, 3))
    assert len(calls) == launches


def test_multitask_has_no_dropout_as_in_jax():
    from unet_torch_tpu_torch.nn.dropout import Dropout

    model = build_model("multi_task_reg", n_channels=3, n_classes=1, base=4,
                        dropout=True, dropout_p=0.5)
    assert all(m.p == 0.0 for m in model.modules() if isinstance(m, Dropout))
    att = build_model("attention", n_channels=3, n_classes=1, base=4,
                      dropout=True, dropout_p=0.5)
    assert any(m.p == 0.5 for m in att.modules() if isinstance(m, Dropout))


@pytest.mark.parametrize("cls,jax_cls,n_classes", [
    (UNetMultitask, JaxUNetMultitask, 1), (UNetAttention, JaxUNetAttention, 3)])
def test_state_dict_from_jax_payload_dispatches_on_the_tree(cls, jax_cls,
                                                            n_classes):
    _, _, params, batch_stats = _jax_model(jax_cls, (32, 32), n_classes)
    sd = ckpt.state_dict_from_jax_payload({"params": params,
                                           "batch_stats": batch_stats})
    cls(3, n_classes, base=8).load_state_dict(sd, strict=True)


def test_log_vars_ride_the_state_dict(tmp_path):
    model = UNetMultitask(3, 1, base=4)
    assert "log_vars" not in model.state_dict()
    model.add_log_vars()
    model.add_log_vars()  # once
    assert model.log_vars.shape == (2,) and model.log_vars.requires_grad
    assert any(p is model.log_vars for p in model.parameters())
    with torch.no_grad():
        model.log_vars.copy_(torch.tensor([0.25, -0.5]))
    path = str(tmp_path / "best.pt")
    ckpt.save_weights(path, model)
    fresh = ckpt.load_weights(path, UNetMultitask(3, 1, base=4))
    assert torch.equal(fresh.log_vars, model.log_vars)
    # a checkpoint without them loads strictly into a model without them
    plain = UNetMultitask(3, 1, base=4)
    ckpt.save_weights(path, plain)
    assert not hasattr(ckpt.load_weights(path, UNetMultitask(3, 1, base=4)),
                       "log_vars")
