"""Topological (persistent-homology) losses (counterpart of
unet_torch_tpu/losses/topo.py).

The loss of Hu et al. (NeurIPS 2019) on the 0-dimensional persistence of the
superlevel filtration of the predicted likelihood, and the localized
`TopoCount` flavour (Abousamra et al., AAAI 2021), each in two halves:

  * the pairing, on the host: the union-find sweep with the elder rule over
    pixels sorted by descending likelihood (native/ph0.cpp through ctypes)
    gives each bar's birth and death critical pixels, sorted by persistence
    and padded to a fixed number of bars. It is sequential by nature and no
    kernel of the card.
  * the loss, on the likelihood's device: a `torch.gather` of the critical
    pixels' likelihoods, so that gradients reach only those pixels. The k
    most persistent bars match the ideal bar (1, 0), the rest the diagonal:
    sum_matched (b - 1)^2 + d^2 + sum_unmatched (b - d)^2, over the batch size.

The single-call `topo_loss` and `topocount_loss` do the work of the JAX
package's `jax.pure_callback`: the detached likelihood is copied to the host,
paired, and the indices copied back. The train steps call the two halves
themselves (train/steps.py::make_topo_steps). The pairing always runs the
native code and raises where it cannot be built or loaded; the numpy
`_superlevel_ph0_np` is the tests' oracle, equal to it.
"""

from __future__ import annotations

import numpy as np
import torch

from unet_torch_tpu_torch.native import ph0 as _native

_NEIGH8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _superlevel_ph0_np(img: np.ndarray, max_bars: int):
    """0-dim PH of the superlevel filtration of ``img`` (H, W), elder rule.

    Returns (birth_idx, death_idx, n_bars): flat pixel indices of each bar's
    birth/death critical pixels, sorted by persistence (descending), padded to
    ``max_bars``.  The essential bar (last surviving component) dies at the global
    minimum pixel.
    """
    h, w = img.shape
    flat = img.ravel()
    order = np.argsort(-flat, kind="stable")
    parent = np.full(h * w, -1, dtype=np.int64)
    birth_of = np.zeros(h * w, dtype=np.int64)  # root -> birth pixel
    births, deaths = [], []

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for px in order:
        parent[px] = px
        birth_of[px] = px
        y, x = divmod(int(px), w)
        for dy, dx in _NEIGH8:
            ny, nx = y + dy, x + dx
            if 0 <= ny < h and 0 <= nx < w:
                npx = ny * w + nx
                if parent[npx] != -1:
                    ra, rb = find(px), find(npx)
                    if ra != rb:
                        ba, bb = birth_of[ra], birth_of[rb]
                        # elder rule: the component with the lower birth value dies
                        if flat[ba] <= flat[bb]:
                            young, old = ra, rb
                            yb = ba
                        else:
                            young, old = rb, ra
                            yb = bb
                        births.append(int(yb))
                        deaths.append(int(px))
                        parent[young] = old
    # essential bar: survives to the global minimum
    if len(order):
        root = find(int(order[0]))
        births.append(int(birth_of[root]))
        deaths.append(int(order[-1]))

    births = np.asarray(births, dtype=np.int64)
    deaths = np.asarray(deaths, dtype=np.int64)
    pers = flat[births] - flat[deaths]
    sel = np.argsort(-pers, kind="stable")[:max_bars]
    births, deaths = births[sel], deaths[sel]
    n = len(births)
    b = np.zeros(max_bars, dtype=np.int32)
    d = np.zeros(max_bars, dtype=np.int32)
    b[:n] = births
    d[:n] = deaths
    return b, d, np.int32(n)


def _count_components_np(mask: np.ndarray) -> int:
    """Connected components (8-connectivity) of a binary mask, on the host."""
    return _native.count_components(mask.astype(np.uint8))


def _pairing_host(likelihood: np.ndarray, target: np.ndarray | None,
                  max_bars: int, kgt_override: np.ndarray | None = None):
    """Host pairing over a batch: (B, H, W) likelihood -> padded bar indices
    and counts. ``kgt_override`` supplies the true component counts (the dot
    maps' sums in the warm-up trainer); otherwise they are the target
    masks' component counts."""
    bsz = likelihood.shape[0]
    births = np.zeros((bsz, max_bars), np.int32)
    deaths = np.zeros((bsz, max_bars), np.int32)
    nbars = np.zeros((bsz,), np.int32)
    kgt = np.zeros((bsz,), np.int32)
    for i in range(bsz):
        births[i], deaths[i], nbars[i] = _native.superlevel_ph0(
            np.asarray(likelihood[i], np.float32), max_bars)
        if kgt_override is not None:
            kgt[i] = int(kgt_override[i])
        else:
            kgt[i] = _count_components_np(target[i] > 0.5)
    return births, deaths, nbars, kgt


def _window_pairing_host(likelihood: np.ndarray, dot_counts: np.ndarray,
                         window: int, bars_per_window: int):
    """The localized pairing: each ``window``² window of the (B, H, W)
    likelihood paired on its own (row-major window grid). Returns births and
    deaths as GLOBAL flat indices (B, nwin * bars_per_window), nbars (B,
    nwin) and the per-window dot counts as kgt (B, nwin), all int32."""
    bsz, h, w = likelihood.shape
    if h % window or w % window:
        raise ValueError(f"window {window} must divide ({h}, {w})")
    gy, gx = h // window, w // window
    nwin = gy * gx
    births = np.zeros((bsz, nwin * bars_per_window), np.int32)
    deaths = np.zeros((bsz, nwin * bars_per_window), np.int32)
    nbars = np.zeros((bsz, nwin), np.int32)
    for i in range(bsz):
        for wy in range(gy):
            for wx in range(gx):
                crop = np.ascontiguousarray(
                    likelihood[i, wy * window:(wy + 1) * window,
                               wx * window:(wx + 1) * window], np.float32)
                b, d, n = _native.superlevel_ph0(crop, bars_per_window)
                # local (window-flat) -> global flat indices
                ly, lx = np.divmod(b.astype(np.int64), window)
                gb = (wy * window + ly) * w + wx * window + lx
                ly, lx = np.divmod(d.astype(np.int64), window)
                gd = (wy * window + ly) * w + wx * window + lx
                k = wy * gx + wx
                s = slice(k * bars_per_window, (k + 1) * bars_per_window)
                births[i, s] = gb
                deaths[i, s] = gd
                nbars[i, k] = n
    return births, deaths, nbars, np.asarray(dot_counts, np.int32)


def _host_f32(x) -> np.ndarray:
    """A tensor or array as a float32 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def persistence_diagram(likelihood, max_bars: int = 64):
    """Birth/death critical-pixel indices of the top-``max_bars`` 0-dim bars
    of an (H, W) likelihood, and their number, as int32 tensors on its
    device."""
    b, d, n = _native.superlevel_ph0(_host_f32(likelihood), max_bars)
    dev = likelihood.device if isinstance(likelihood, torch.Tensor) else None
    return (torch.from_numpy(b).to(dev), torch.from_numpy(d).to(dev),
            torch.tensor(int(n), dtype=torch.int32, device=dev))


def _logit_map(logits):
    return logits[..., 0] if logits.dim() == 4 else logits


def _bar_penalty(bvals, dvals, nbars, kgt, nbar):
    """sum_matched (b - 1)^2 + d^2 + sum_unmatched (b - d)^2: within each
    group's first nbars bars the first kgt match (1, 0)."""
    idx = torch.arange(nbar, device=bvals.device)
    valid = idx < nbars.unsqueeze(-1)
    matched = valid & (idx < kgt.unsqueeze(-1))
    unmatched = valid & ~matched
    zero = torch.zeros((), dtype=bvals.dtype, device=bvals.device)
    return (torch.where(matched, (bvals - 1.0) ** 2 + dvals ** 2, zero).sum()
            + torch.where(unmatched, (bvals - dvals) ** 2, zero).sum())


def _gather(lik, births, deaths):
    flat = lik.reshape(lik.shape[0], -1)
    return (torch.gather(flat, 1, births.long()),
            torch.gather(flat, 1, deaths.long()))


def topo_loss_from_pairing(logits, births, deaths, nbars, kgt,
                           max_bars: int = 64):
    """The differentiable half of the topo loss: given pairing indices
    (computed on the host), gather the critical pixels' likelihoods and
    penalise. logits (B, H, W, 1) or (B, H, W); births/deaths (B, max_bars),
    nbars/kgt (B,), on the logits' device."""
    lik = torch.sigmoid(_logit_map(logits))
    bvals, dvals = _gather(lik, births, deaths)
    return _bar_penalty(bvals, dvals, nbars, kgt, max_bars) / lik.shape[0]


def topocount_loss_from_pairing(logits, births, deaths, nbars, kgt,
                                bars_per_window: int):
    """The differentiable half of the localized TopoCount loss: births and
    deaths (B, nwin * bars_per_window) global flat indices, nbars and kgt
    (B, nwin); in each window the kgt most persistent bars match (1, 0) and
    the rest the diagonal."""
    lik = torch.sigmoid(_logit_map(logits))
    bsz, nwin = nbars.shape
    bvals, dvals = _gather(lik, births, deaths)
    bvals = bvals.reshape(bsz, nwin, bars_per_window)
    dvals = dvals.reshape(bsz, nwin, bars_per_window)
    return _bar_penalty(bvals, dvals, nbars, kgt, bars_per_window) / bsz


def compute_pairing(likelihood, target, max_bars: int = 64,
                    kgt_override=None):
    """Host-side pairing on concrete arrays. ``target`` may be None when
    ``kgt_override`` supplies the component counts (the mask is only read
    for its component count)."""
    if target is None and kgt_override is None:
        raise ValueError("target may only be None with kgt_override")
    return _pairing_host(np.asarray(likelihood),
                         None if target is None else np.asarray(target),
                         max_bars, kgt_override)


def downsample_max(x, ds: int):
    """2-D max-pool of a (B, H, W) map by ``ds`` (H and W divisible by it),
    a torch tensor or a numpy array alike; ds = 1 is the identity. On a
    tensor the gradient goes to each window's maximum (split evenly between
    equal ones, as JAX's reduce-max does).

    The superlevel filtration of the pooled likelihood keeps every local
    maximum's birth while the host pairs ds² fewer pixels; sigmoid is
    monotone, so pooling the logits before it equals pooling the
    likelihood."""
    if ds == 1:
        return x
    b, h, w = x.shape
    x = x.reshape(b, h // ds, ds, w // ds, ds)
    if isinstance(x, torch.Tensor):
        return x.amax(dim=(2, 4))
    return x.max(axis=(2, 4))


def effective_window(h: int, w: int, window: int) -> int:
    """Largest window <= ``window`` that tiles (h, w) exactly: clamps the
    512²-tuned default (64) to small inputs (a 64² crop gets one window) and
    walks down to a common divisor for odd sizes.

    Refuses to degenerate: an awkward size (a prime 509) would walk to 1,
    one pairing per pixel. Below a floor of 8 (when the input is at least
    that big) this raises instead; pad or crop the input to a multiple of 8
    or use the global ``TopoLoss``."""
    eff = max(1, min(window, h, w))
    while h % eff or w % eff:
        eff -= 1
    if eff < min(8, h, w):
        raise ValueError(
            f"TopoCount window degenerated to {eff} for a {h}x{w} input "
            f"(no common divisor >= 8 under window={window}); pad/crop the "
            f"input to a multiple of 8 or use the global TopoLoss")
    return eff


def window_dot_counts(gt_dot, window: int):
    """Per-window dot counts (B, nwin) of a (B, H, W) dot map, a torch
    tensor or a numpy array (row-major window grid, as
    _window_pairing_host)."""
    b, h, w = gt_dot.shape
    gy, gx = h // window, w // window
    blocks = gt_dot.reshape(b, gy, window, gx, window)
    if isinstance(blocks, torch.Tensor):
        return blocks.sum(dim=(2, 4)).reshape(b, gy * gx)
    return blocks.sum(axis=(2, 4)).reshape(b, gy * gx)


def compute_pairing_windows(likelihood, gt_dot, window: int,
                            bars_per_window: int):
    """Host-side localized pairing on concrete arrays; gt_dot is a (B, H, W)
    dot map or precomputed (B, nwin) counts."""
    gt_dot = np.asarray(gt_dot)
    counts = window_dot_counts(gt_dot, window) if gt_dot.ndim == 3 else gt_dot
    return _window_pairing_host(np.asarray(likelihood), counts, window,
                                bars_per_window)


def _to_device(arrays, device):
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


def topocount_loss(pred, gt_dot, window: int = 64, bars_per_window: int = 8):
    """Localized TopoCount loss of (B, H, W, 1) or (B, H, W) logits against
    a (B, H, W) dot map (one object a dot): the detached likelihood is
    paired window by window on the host, the loss gathered on the device."""
    lik = torch.sigmoid(_logit_map(pred))
    bsz, h, w = lik.shape
    window = effective_window(h, w, window)
    counts = window_dot_counts(gt_dot, window).to(torch.int32)
    pairing = _window_pairing_host(_host_f32(lik), counts.cpu().numpy(),
                                   window, bars_per_window)
    return topocount_loss_from_pairing(pred, *_to_device(pairing, pred.device),
                                       bars_per_window)


def topo_loss(pred, target, max_bars: int = 64):
    """Topological loss of (B, H, W, 1) or (B, H, W) logits against a binary
    (B, H, W) target: the detached likelihood is paired on the host (k_gt =
    the target's connected components), the loss gathered on the device,
    differentiable through the critical pixels' likelihoods."""
    lik = torch.sigmoid(_logit_map(pred))
    t = (target > 0.5).to(torch.float32)
    pairing = _pairing_host(_host_f32(lik), t.cpu().numpy(), max_bars)
    return topo_loss_from_pairing(pred, *_to_device(pairing, pred.device),
                                  max_bars)
