"""The port's main-path losses (unet_torch_tpu_torch/losses) against the JAX
package's, on seeded numpy NHWC logits and labels, and the `calc_loss`
dispatch: its keys, the not-ported keys and unknown keys."""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("key,item", [("mse", "queue 1 item 8"),
                                      ("HausdorffDTLoss", "queue 1 item 9"),
                                      ("Tversky", "queue 1 item 9"),
                                      ("TopoCount", "queue 1 item 12")])
def test_calc_loss_names_the_roadmap_item_of_unported_keys(key, item):
    logits, labels = (torch.from_numpy(a) for a in _inputs(3))
    with pytest.raises(NotImplementedError, match=item):
        calc_loss(logits, labels, loss_type=key, num_classes=3)
    with pytest.raises(NotImplementedError, match=item):
        get_loss_fn(key, 3)


def test_calc_loss_raises_on_unknown_key():
    logits, labels = (torch.from_numpy(a) for a in _inputs(3))
    with pytest.raises(KeyError):
        calc_loss(logits, labels, loss_type="dice_bce_mcc", num_classes=3)
    with pytest.raises(KeyError):
        get_loss_fn("nope", 3)
