"""The port's UNet (unet_torch_tpu_torch) against the JAX package's: the
weights bridge, the eval forward on the CPU in f32 and in bf16, and
build_model's contract."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_torch_tpu.ckpt.torch_import import load_torch_unet
from unet_torch_tpu.models.unet import UNet as JaxUNet
from unet_torch_tpu_torch.ckpt.bridge import state_dict_from_flax
from unet_torch_tpu_torch.core.rng import seed_everything
from unet_torch_tpu_torch.eval.reports import make_predict_fn
from unet_torch_tpu_torch.models.unet import UNet, build_model


def _jax_unet(fold, hw, seed=0):
    """A JAX UNet(3, 3, base=8), its input, and its trees with seeded BN
    running statistics: with the default mean 0 / var 1 folding is trivial."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *hw, 3).astype(np.float32)
    model = JaxUNet(3, 3, base=8, fold=fold)
    variables = model.init(jax.random.key(seed), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])

    def stat(path, a):
        if path[-1].key == "var":
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        return (rng.randn(*a.shape) * 0.1).astype(np.float32)

    batch_stats = jax.tree_util.tree_map_with_path(
        stat, jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    return model, x, params, batch_stats


def test_bridge_roundtrips_through_load_torch_unet():
    _, _, params, batch_stats = _jax_unet(False, (32, 32))
    sd = state_dict_from_flax(params, batch_stats)
    zeros = lambda t: jax.tree_util.tree_map(np.zeros_like, t)  # noqa: E731
    p2, b2 = load_torch_unet(sd, zeros(params), zeros(batch_stats))
    for ours, ref in ((p2, params), (b2, batch_stats)):
        assert (jax.tree_util.tree_structure(ours)
                == jax.tree_util.tree_structure(ref))
        for a, b in zip(jax.tree_util.tree_leaves(ours),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, b)
    # the reference's names are the port's: a strict load takes every key
    UNet(3, 3, base=8).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("fold,hw", [(False, (64, 64)), (True, (64, 64)),
                                     (False, (60, 52))])
def test_eval_forward_matches_jax(fold, hw):
    """fold=True is the served config's layout (same param tree); 60x52
    pools to odd sizes, so floor pooling and pad-to-match both run."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, x, params, batch_stats = _jax_unet(fold, hw)
    ref = np.asarray(model.apply({"params": params,
                                  "batch_stats": batch_stats},
                                 jnp.asarray(x), train=False))
    port = UNet(3, 3, base=8)
    port.load_state_dict(state_dict_from_flax(params, batch_stats),
                         strict=True)
    port.eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert out.shape == ref.shape and out.dtype == torch.float32
    # the bound of tests/test_torch_parity.py (JAX against torch, f32)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=1e-3)


def bf16_ulp(peak):
    """The spacing of bfloat16 values at `peak` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(peak)) - 7)


@pytest.mark.parametrize("fold", [False, True])
def test_bf16_eval_forward_matches_jax_bf16(fold):
    """The bf16 eval forward through make_predict_fn against the JAX UNet
    with dtype=bfloat16, same weights and input. The two round at other
    places (JAX's TPUBatchNorm applies the affine in bf16 after a bf16 conv;
    the port's fused conv applies it in f32 and rounds once), so they are
    held to each other within 8 bf16 ulps of the logits' peak (read: 4.0),
    and the port's distance from the f32 forward to twice JAX's own plus an
    ulp (read: 2.3 against 2.1-2.5 ulps): a difference beyond rounding would
    break the second bound."""
    model, x, params, batch_stats = _jax_unet(fold, (64, 64))
    variables = {"params": params, "batch_stats": batch_stats}
    ref32 = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    ref16 = JaxUNet(3, 3, base=8, fold=fold, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x), train=False)
    assert ref16.dtype == jnp.bfloat16
    ref16 = np.asarray(ref16.astype(jnp.float32))
    port = UNet(3, 3, base=8)
    port.load_state_dict(state_dict_from_flax(params, batch_stats),
                         strict=True)
    predict = make_predict_fn(port.to(torch.bfloat16), "cpu", torch.bfloat16)
    out = predict(x)
    assert out.dtype == torch.bfloat16 and out.shape == ref16.shape
    out = out.float().numpy()
    ulp = bf16_ulp(np.abs(ref32).max())
    assert np.abs(out - ref16).max() <= 8 * ulp
    assert (np.abs(out - ref32).max()
            <= 2 * np.abs(ref16 - ref32).max() + ulp)


def test_init_is_seeded_by_the_generator():
    a = UNet(3, 3, base=4, generator=seed_everything(3))
    draw = np.random.rand()
    b = UNet(3, 3, base=4, generator=seed_everything(3))
    assert np.random.rand() == draw  # numpy is seeded too
    c = UNet(3, 3, base=4, generator=seed_everything(4))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.inc.double_conv[0].weight,
                           c.inc.double_conv[0].weight)


def test_build_model_contract():
    with pytest.warns(UserWarning, match="fold"):
        model = build_model("single", n_channels=-2, n_classes=3, base=4,
                            fold=True)
    assert model.inc.double_conv[0].in_channels == 3
    # the TransUnet family has its own builder, as in the JAX package; its
    # UNet fallback is the plain UNet
    with pytest.raises(ValueError, match="build_transunet"):
        build_model("TransUnet", n_channels=3, n_classes=3)
    assert isinstance(build_model("TransUnet_unet_fallback", n_channels=3,
                                  n_classes=3, base=4), UNet)
    with pytest.raises(TypeError):
        build_model("single", n_channels=3, n_classes=3, mesh={"data": 8})
    with pytest.raises(ValueError):
        build_model("nope", n_channels=3, n_classes=3)
