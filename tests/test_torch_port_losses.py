"""The port's losses (unet_torch_tpu_torch/losses) against the JAX package's,
on seeded numpy NHWC logits and labels: values, gradients with respect to the
logits, and the `calc_loss` dispatch: its keys, the topo keys and unknown
keys."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_torch_tpu.losses import calc_loss as jax_calc_loss
from unet_torch_tpu.losses import functional as JF
from unet_torch_tpu_torch.losses import calc_loss, get_loss_fn
from unet_torch_tpu_torch.losses import functional as PF

# f32 sums over 2*16*16 pixels in another order: about 1e-7 of values O(1)
TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs(c, seed=0, b=2, h=16, w=16):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, h, w, c) * 2).astype(np.float32)
    labels = rng.randint(0, c, (b, h, w)).astype(np.float32)
    return logits, labels


def _both(fn_jax, fn_port, logits, labels, *args, **kw):
    ref = float(fn_jax(jnp.asarray(logits), jnp.asarray(labels), *args, **kw))
    ours = fn_port(torch.from_numpy(logits), torch.from_numpy(labels), *args,
                   **kw)
    assert ours.dtype == torch.float32 and ours.dim() == 0
    return ours.item(), ref


@pytest.mark.parametrize("c", [2, 3, 4, 10])
def test_softmax_cross_entropy_matches_jax(c):
    # c = 2 takes the logit-margin form in both
    ours, ref = _both(JF.softmax_cross_entropy, PF.softmax_cross_entropy,
                      *_inputs(c, seed=c), c)
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("c,softmax,weights", [
    (3, True, None), (4, False, None), (3, True, [0.2, 0.3, 0.5])])
def test_multiclass_dice_loss_matches_jax(c, softmax, weights):
    logits, labels = _inputs(c, seed=5)
    if not softmax:  # probabilities in, as the reference passes them
        logits = np.abs(logits) / np.abs(logits).sum(-1, keepdims=True)
    ours, ref = _both(JF.multiclass_dice_loss, PF.multiclass_dice_loss,
                      logits, labels, c, weights=weights, softmax=softmax)
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("c", [2, 3, 4, 10])
def test_dice_bce_mc_loss_matches_jax(c):
    """C <= 8 is the JAX package's class-planes path
    (_dice_bce_mc_planes), C = 10 its general path; the port has one."""
    ours, ref = _both(JF.dice_bce_mc_loss, PF.dice_bce_mc_loss,
                      *_inputs(c, seed=10 + c), c)
    np.testing.assert_allclose(ours, ref, **TOL)
    ours, ref = _both(JF.dice_bce_mc_loss, PF.dice_bce_mc_loss,
                      *_inputs(c, seed=10 + c), c, 0.3)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_dice_score_matches_jax():
    ours, ref = _both(JF.dice_score, PF.dice_score, *_inputs(3, seed=7), 3)
    np.testing.assert_allclose(ours, ref, **TOL)
    logits, labels = _inputs(1, seed=8)
    labels = (np.random.RandomState(8).rand(*labels.shape) > 0.5).astype(
        np.float32)
    ours, ref = _both(JF.dice_score, PF.dice_score, logits, labels)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_bf16_logits_are_computed_in_f32():
    logits, labels = _inputs(3, seed=9)
    t = torch.from_numpy(logits)
    y = torch.from_numpy(labels)
    low = PF.dice_bce_mc_loss(t.to(torch.bfloat16), y, 3)
    assert low.dtype == torch.float32
    ref = PF.dice_bce_mc_loss(t.to(torch.bfloat16).float(), y, 3)
    assert low.item() == ref.item()


@pytest.mark.parametrize("key,c", [("CE", 3), ("dice_bce_mc", 3),
                                   ("dice_score_mc", 4), ("dice_score", 1)])
def test_calc_loss_keys_match_jax(key, c):
    logits, labels = _inputs(c, seed=11)
    if c == 1:
        labels = (labels > 0).astype(np.float32)
    ref = float(jax_calc_loss(jnp.asarray(logits), jnp.asarray(labels),
                              loss_type=key, num_classes=c))
    ours = calc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                     loss_type=key, num_classes=c)
    np.testing.assert_allclose(ours.item(), ref, **TOL)
    ours = get_loss_fn(key, c)(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    np.testing.assert_allclose(ours.item(), ref, **TOL)


def _blob_target(b, h, w, seed):
    """Binary maps of a few disks, as the binary heads' labels are."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    target = np.zeros((b, h, w), np.float32)
    for m in target:
        for cy, cx, r in zip(rng.randint(0, h, 3), rng.randint(0, w, 3),
                             rng.randint(2, 6, 3)):
            m[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    return target


def _zoo_inputs(key, seed=0, b=2, h=24, w=20):
    """(logits, target, num_classes) as the key's users feed it."""
    rng = np.random.RandomState(seed)
    if key in ("log_cosh_dice_loss", "Tversky_mc"):
        return (rng.randn(b, h, w, 3).astype(np.float32),
                rng.randint(0, 3, (b, h, w)).astype(np.float32), 3)
    if key == "mseMC":
        return (rng.randn(b, h, w, 2).astype(np.float32),
                rng.rand(b, h, w, 2).astype(np.float32), 2)
    logits = rng.randn(b, h, w, 1).astype(np.float32)
    if key in ("mse", "rmse", "l1loss"):
        return logits, rng.rand(b, h, w, 1).astype(np.float32), 1
    return logits, _blob_target(b, h, w, seed + 1), 1


# every key this slice ported; Tversky_mc is Tversky on a 3-class softmax
ZOO = ["BCE", "TopK", "BCE_HEM", "FL", "mse", "mseMC", "rmse", "l1loss",
       "dice", "dice_bce", "log_cosh_dice_loss", "HausdorffDTLoss",
       "HausdorffERLoss", "ActiveContourLoss", "Tversky", "Tversky_mc"]
# f32 sums over 960 pixels in another order. The two Hausdorff losses weigh
# each pixel by a power of a distance, or erode ten times through a 3x3
# convolution whose taps the two frameworks add in another order: 1e-5
# relative. The active-contour loss is a sum, not a mean, of O(1) terms.
ZOO_TOL = {"HausdorffDTLoss": dict(atol=0, rtol=1e-5),
           "HausdorffERLoss": dict(atol=0, rtol=1e-5),
           "ActiveContourLoss": dict(atol=0, rtol=1e-6)}
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("key", ZOO)
def test_loss_zoo_values_and_gradients_match_jax(key):
    logits, target, c = _zoo_inputs(key, seed=len(key))
    name = key.split("_mc")[0] if key == "Tversky_mc" else key
    ref, ref_grad = jax.value_and_grad(
        lambda p: jax_calc_loss(p, jnp.asarray(target), loss_type=name,
                                num_classes=c))(jnp.asarray(logits))
    p = torch.from_numpy(logits).requires_grad_()
    ours = calc_loss(p, torch.from_numpy(target), loss_type=name,
                     num_classes=c)
    assert ours.dtype == torch.float32 and ours.dim() == 0
    np.testing.assert_allclose(ours.item(), float(ref),
                               **ZOO_TOL.get(key, TOL))
    ours.backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad),
                               **GRAD_TOL)
    if key == "HausdorffERLoss":  # the eroded bound is a constant
        assert not p.grad.any()
    else:
        assert p.grad.abs().max() > 0


@pytest.mark.parametrize("key", ["dice_bce", "HausdorffDTLoss", "mse"])
def test_loss_zoo_takes_bf16_logits_in_f32(key):
    logits, target, c = _zoo_inputs(key, seed=3)
    low = torch.from_numpy(logits).to(torch.bfloat16)
    out = calc_loss(low, torch.from_numpy(target), loss_type=key,
                    num_classes=c)
    ref = calc_loss(low.float(), torch.from_numpy(target), loss_type=key,
                    num_classes=c)
    assert out.dtype == torch.float32 and out.item() == ref.item()


def test_bce_hem_batch_base_matches_jax():
    logits, target, _ = _zoo_inputs("BCE_HEM", seed=4, b=4)
    ours, ref = _both(JF.bce_hem_loss, PF.bce_hem_loss, logits, target,
                      batch_base=True)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_hausdorff_dt_of_an_image_without_foreground_matches_jax():
    """A target without foreground has a zero field; a prediction without
    foreground likewise (the flag is per image and stays on the device)."""
    logits, target, _ = _zoo_inputs("HausdorffDTLoss", seed=5)
    target[1] = 0
    logits[0] = -np.abs(logits[0])
    ours, ref = _both(JF.hausdorff_dt_loss, PF.hausdorff_dt_loss, logits,
                      target)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


def test_multitask_uncertainty_loss_matches_jax():
    losses = np.array([0.7, 1.9], np.float32)
    log_vars = np.array([0.3, -0.5], np.float32)
    ref = float(JF.multitask_uncertainty_loss(
        list(jnp.asarray(losses)), list(jnp.asarray(log_vars)),
        [True, False]))
    ours = PF.multitask_uncertainty_loss(
        list(torch.from_numpy(losses)), list(torch.from_numpy(log_vars)),
        [True, False])
    np.testing.assert_allclose(ours.item(), ref, **TOL)


def test_class_number_is_the_default_num_classes():
    from unet_torch_tpu_torch import losses as port_losses

    logits, labels = (torch.from_numpy(a) for a in _inputs(3, seed=12))
    port_losses.set_class_number(3)
    try:
        assert port_losses.CLASS_NUMBER == 3
        assert (calc_loss(logits, labels, loss_type="CE").item()
                == calc_loss(logits, labels, loss_type="CE",
                             num_classes=3).item())
    finally:
        port_losses.set_class_number(2)


def test_calc_loss_carries_every_jax_key_but_the_topo_ones():
    """Since the topo slice the port carries every key, the topo ones too,
    and the same set of topo names."""
    from unet_torch_tpu.losses import _DISPATCH as jax_dispatch
    from unet_torch_tpu.losses import TOPO_LOSSES
    from unet_torch_tpu_torch.losses import _DISPATCH as port_dispatch
    from unet_torch_tpu_torch.losses import TOPO_LOSSES as PORT_TOPO_LOSSES

    assert set(port_dispatch) == set(jax_dispatch)
    assert PORT_TOPO_LOSSES == TOPO_LOSSES


@pytest.mark.parametrize("key", ["TopoLoss", "MyTopoLossVR", "myTopoLoss",
                                 "TopoCount"])
def test_calc_loss_names_the_roadmap_item_of_unported_keys(key):
    """The keys that raised until the topo slice (ROADMAP queue 1 item 12)
    now run: the loss and its gradient as JAX's, on binary-head logits (the
    seed's two likelihoods pair alike in both frameworks). `myTopoLoss` is
    a name of the reference trainer's loop, not of calc_loss: a KeyError in
    both."""
    logits = _inputs(1, seed=4)[0]
    target = (_inputs(3, seed=4)[1] > 0).astype(np.float32)
    if key == "myTopoLoss":
        with pytest.raises(KeyError):
            jax_calc_loss(jnp.asarray(logits), jnp.asarray(target),
                          loss_type=key, num_classes=1)
        with pytest.raises(KeyError):
            calc_loss(torch.from_numpy(logits), torch.from_numpy(target),
                      loss_type=key, num_classes=1)
        with pytest.raises(KeyError):
            get_loss_fn(key, 1)
        return
    ref, ref_grad = jax.value_and_grad(lambda p: jax_calc_loss(
        p, jnp.asarray(target), loss_type=key, num_classes=1))(
            jnp.asarray(logits))
    p = torch.from_numpy(logits).requires_grad_()
    ours = get_loss_fn(key, 1)(p, torch.from_numpy(target))
    ours.backward()
    assert float(ref) > 0
    np.testing.assert_allclose(ours.item(), float(ref), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad),
                               atol=1e-5, rtol=1e-5)


def test_calc_loss_raises_on_unknown_key():
    logits, labels = (torch.from_numpy(a) for a in _inputs(3))
    with pytest.raises(KeyError):
        calc_loss(logits, labels, loss_type="dice_bce_mcc", num_classes=3)
    with pytest.raises(KeyError):
        get_loss_fn("nope", 3)
