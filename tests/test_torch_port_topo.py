"""The port's topological losses (unet_torch_tpu_torch/losses/topo.py) and
its native pairing against the JAX package's, on the CPU: the pairings equal
(births, deaths, bar counts, k_gt), the losses within 1e-6 and their
gradients within 1e-5, `effective_window`'s values and its raise,
`mr_accuracy` equal, and the calc_loss keys.

Inputs are drawn with numpy from a seed, at 32-64 pixels a side. The
pairings are compared on one likelihood array, where ties order alike in
both (stable sorts). Where each framework forms the likelihood with its own
sigmoid (the two differ in the last bit at about 1% of the pixels), the
seeds are ones whose bars do not tie: the two likelihoods pair alike
(`_pairs_alike` asserts it), so a difference in the loss is a fault.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_torch_tpu.eval import metrics as jax_metrics
from unet_torch_tpu.losses import topo as jax_topo
from unet_torch_tpu_torch.eval import metrics as port_metrics
from unet_torch_tpu_torch.losses import topo as port_topo
from unet_torch_tpu_torch.native import ph0 as port_ph0

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _logits(seed, b=2, size=32):
    """Smooth blobs plus noise: a few persistent peaks and many short bars."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    maps = []
    for _ in range(b):
        m = rng.randn(size, size) * 0.5
        for _ in range(4):
            cy, cx = rng.randint(0, size, 2)
            m += 4.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 12.0)
        maps.append(m - 2.0)
    return np.stack(maps).astype(np.float32)


def _dots(seed, b=2, size=32, n=5):
    rng = np.random.RandomState(seed + 100)
    dot = np.zeros((b, size, size), np.float32)
    for i in range(b):
        dot[i, rng.randint(0, size, n), rng.randint(0, size, n)] = 1.0
    return dot


def _mask(seed, b=2, size=32):
    return (_logits(seed + 200, b, size) > 0.0).astype(np.float32)


def _lik(logits):
    return 1.0 / (1.0 + np.exp(-logits))


def _pairs_alike(logits, window=None):
    """Assert that torch's and JAX's sigmoid of the logits give the same
    pairing: the global one, and with `window` the localized one."""
    logits = logits[..., 0] if logits.ndim == 4 else logits
    liks = [torch.sigmoid(torch.from_numpy(logits)).numpy(),
            np.asarray(jax.nn.sigmoid(jnp.asarray(logits)))]
    kgt = np.ones(len(logits), np.int64)
    pairings = [port_topo.compute_pairing(lik, None, 64, kgt_override=kgt)
                for lik in liks]
    if window is not None:
        counts = np.zeros((len(logits), (logits.shape[1] // window) ** 2))
        pairings += [port_topo.compute_pairing_windows(lik, counts, window, 8)
                     for lik in liks]
    for a, b in zip(pairings[::2], pairings[1::2]):
        _assert_equal_pairings(a, b)


def _assert_equal_pairings(ours, ref):
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("seed", [0, 3])
def test_native_pairing_equals_numpy_oracle(seed):
    for m in _lik(_logits(seed, b=2, size=40)):
        for bars in (4, 64, 4096):
            ours = port_ph0.superlevel_ph0(m, bars)
            ref = port_topo._superlevel_ph0_np(m, bars)
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(a, b)
    mask = _mask(seed)[0] > 0
    assert (port_ph0.count_components(mask)
            == jax_metrics.connected_component_count(mask))


@pytest.mark.parametrize("ds", [1, 2])
def test_compute_pairing_equals_jax(ds):
    logits = _logits(1, size=64)
    lik = _lik(port_topo.downsample_max(logits, ds))
    np.testing.assert_array_equal(lik, _lik(jax_topo.downsample_max(logits,
                                                                   ds)))
    kgt = _dots(1, size=64).sum(axis=(1, 2)).astype(np.int64)
    _assert_equal_pairings(
        port_topo.compute_pairing(lik, None, 64, kgt_override=kgt),
        jax_topo.compute_pairing(lik, None, 64, kgt_override=kgt))
    target = _mask(1, size=64)[:, ::ds, ::ds]
    _assert_equal_pairings(port_topo.compute_pairing(lik, target, 16),
                           jax_topo.compute_pairing(lik, target, 16))
    with pytest.raises(ValueError):
        port_topo.compute_pairing(lik, None, 64)


@pytest.mark.parametrize("ds", [1, 2])
def test_compute_pairing_windows_equals_jax(ds):
    logits = _logits(2, size=64)
    lik = _lik(port_topo.downsample_max(logits, ds))
    dots = _dots(2, size=64)
    window = port_topo.effective_window(*lik.shape[1:], 16)
    counts = port_topo.window_dot_counts(dots, window * ds)
    np.testing.assert_array_equal(
        counts, jax_topo.window_dot_counts(dots, window * ds))
    for gt in (counts, dots[:, ::ds, ::ds]):
        _assert_equal_pairings(
            port_topo.compute_pairing_windows(lik, gt, window, 8),
            jax_topo.compute_pairing_windows(lik, gt, window, 8))
    with pytest.raises(ValueError, match="must divide"):
        port_topo.compute_pairing_windows(lik, counts, 24, 8)


def test_persistence_diagram_equals_jax():
    lik = _lik(_logits(4))[0]
    ours = port_topo.persistence_diagram(torch.from_numpy(lik), 16)
    ref = jax_topo.persistence_diagram(jnp.asarray(lik), 16)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _jax_loss_and_grad(fn, logits, *args):
    loss, grad = jax.value_and_grad(lambda p: fn(p, *args))(
        jnp.asarray(logits))
    return float(loss), np.asarray(grad)


def _port_loss_and_grad(fn, logits, *args):
    p = torch.from_numpy(logits).requires_grad_()
    loss = fn(p, *args)
    loss.backward()
    return loss.item(), p.grad.numpy()


def _assert_loss_and_grad(ours, ref):
    assert ref[0] > 0
    np.testing.assert_allclose(ours[0], ref[0], **LOSS_TOL)
    np.testing.assert_allclose(ours[1], ref[1], **GRAD_TOL)
    assert np.count_nonzero(ours[1]) > 0


@pytest.mark.parametrize("channel_axis", [False, True])
def test_topo_loss_and_gradient_match_jax(channel_axis):
    logits = _logits(5)
    _pairs_alike(logits)
    if channel_axis:
        logits = logits[..., None]
    target = _mask(5)
    _assert_loss_and_grad(
        _port_loss_and_grad(port_topo.topo_loss, logits,
                            torch.from_numpy(target)),
        _jax_loss_and_grad(jax_topo.topo_loss, logits, jnp.asarray(target)))


@pytest.mark.parametrize("window", [64, 16, 12])
def test_topocount_loss_and_gradient_match_jax(window):
    """window 64 clamps to the 32² map, 12 walks down to 8."""
    logits = _logits(6)[..., None]
    _pairs_alike(logits, port_topo.effective_window(32, 32, window))
    dots = _dots(6)
    _assert_loss_and_grad(
        _port_loss_and_grad(port_topo.topocount_loss, logits,
                            torch.from_numpy(dots), window),
        _jax_loss_and_grad(jax_topo.topocount_loss, logits,
                           jnp.asarray(dots), window))


@pytest.mark.parametrize("localized", [False, True])
def test_loss_from_pairing_matches_jax(localized):
    """The differentiable halves on the same indices, with some bars
    unmatched and some padded (nbars < max_bars)."""
    logits = _logits(7)
    lik = _lik(logits)
    if localized:
        counts = port_topo.window_dot_counts(_dots(7, n=12), 16)
        pairing = port_topo.compute_pairing_windows(lik, counts, 16, 8)
        port_fn, jax_fn, extra = (port_topo.topocount_loss_from_pairing,
                                  jax_topo.topocount_loss_from_pairing, 8)
    else:
        pairing = port_topo.compute_pairing(
            lik, None, 64, kgt_override=np.array([3, 7]))
        port_fn, jax_fn, extra = (port_topo.topo_loss_from_pairing,
                                  jax_topo.topo_loss_from_pairing, 64)
    assert (pairing[2] > 0).all()
    _assert_loss_and_grad(
        _port_loss_and_grad(port_fn, logits,
                            *(torch.from_numpy(a) for a in pairing), extra),
        _jax_loss_and_grad(jax_fn, logits,
                           *(jnp.asarray(a) for a in pairing), extra))


def test_downsample_max_matches_jax_with_its_gradient():
    """Also on a map with tied maxima in a window, where both split the
    gradient evenly."""
    x = _logits(8)
    x[0, :2, :2] = 5.0
    g = np.random.RandomState(8).randn(2, 16, 16).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_()
    out = port_topo.downsample_max(t, 2)
    (out * torch.from_numpy(g)).sum().backward()
    ref, vjp = jax.vjp(lambda a: jax_topo.downsample_max(a, 2),
                       jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), **GRAD_TOL)
    assert port_topo.downsample_max(t, 1) is t


@pytest.mark.parametrize("h,w,window", [
    (512, 512, 64), (64, 64, 64), (32, 32, 64), (48, 48, 64), (96, 64, 64),
    (40, 24, 16), (7, 7, 64), (100, 60, 64), (509, 509, 64),
    (512, 509, 64), (72, 90, 64)])
def test_effective_window_equals_jax(h, w, window):
    try:
        ref = jax_topo.effective_window(h, w, window)
    except ValueError as e:
        with pytest.raises(ValueError, match="degenerated"):
            port_topo.effective_window(h, w, window)
        assert "degenerated" in str(e)
        return
    assert port_topo.effective_window(h, w, window) == ref


def test_mr_accuracy_equals_jax():
    logits = _logits(9, b=3, size=48)[..., None]
    dots = _dots(9, b=3, size=48)
    dots[2] = 0  # an image without dots
    assert (port_metrics.mr_accuracy(logits, dots)
            == jax_metrics.mr_accuracy(logits, dots))
    assert (port_metrics.mr_accuracy(logits[..., 0], dots[:2])
            == jax_metrics.mr_accuracy(logits[..., 0], dots[:2]))
    mask = logits[0, ..., 0] > 0
    assert (port_metrics.connected_component_count(mask)
            == jax_metrics.connected_component_count(mask))


@pytest.mark.parametrize("key", ["TopoLoss", "MyTopoLoss1", "MyTopoLoss2",
                                 "MyTopoLossGraph", "MyTopoLossVR",
                                 "TopoCount"])
def test_calc_loss_topo_keys_match_jax(key):
    from unet_torch_tpu.losses import calc_loss as jax_calc_loss
    from unet_torch_tpu_torch.losses import calc_loss

    logits = _logits(10)[..., None]
    _pairs_alike(logits, 32)
    target = _dots(10) if key == "TopoCount" else _mask(10)
    ours = calc_loss(torch.from_numpy(logits), torch.from_numpy(target),
                     loss_type=key, num_classes=1)
    ref = jax_calc_loss(jnp.asarray(logits), jnp.asarray(target),
                        loss_type=key, num_classes=1)
    np.testing.assert_allclose(ours.item(), float(ref), **LOSS_TOL)
