"""The predict stream: whole-slide inference over tiles held in host memory,
through `make_predict_fn(model, device, dtype, classes=True)` in
`_batched_eval`'s one-deep order: batch k is queued before batch k - 1's
class map is read back with `_to_host`.

The mix's file gives `pool` (the preprocessed tiles in host memory),
`cells_per_tile`, `batch` (the eval chunk), `warm_batches`,
`profile_batches` (the traced sub-window) and `sample_batches` (how many of
the window's batches the check judges, drawn from the seed by reservoir
sampling). Each batch's tiles are drawn from the pool by the seed."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench import faults
from perfbench.core import tiles
from perfbench.core.trace import no_span
from perfbench.loops import program

FAULTS = {"altered": faults.altered}


class State:
    pass


def setup(cell, seeds, device, workdir, fault=None):
    from unet_torch_tpu_torch.eval.reports import _to_host, make_predict_fn

    mix = cell["traffic_spec"]
    s = State()
    s.cell, s.seeds, s.device = cell, seeds, device
    s.cfg = cfg = program.config(cell, workdir, workdir)
    size = cfg.model.input_size[0]
    t0 = time.perf_counter()
    s.pool = tiles.pool(seeds["data"], mix["pool"], size,
                        mix["cells_per_tile"], cfg.model.num_class)
    t1 = time.perf_counter()
    _, model, dtype = program.build(cfg, seeds["program"], seeds["weights"],
                                    device)
    t2 = time.perf_counter()
    s.model = model
    s.predict = make_predict_fn(model, device, dtype, classes=True)
    if fault is not None:
        s.predict = fault(s.predict)
    s.to_host = _to_host
    s.batch = mix["batch"]
    s.draw = np.random.RandomState(seeds["traffic"])
    s.sampler = np.random.RandomState(seeds["sample"])
    s.samples = []  # (batch number, tile indices, class maps)
    s.k = 0  # batches dispatched
    for _ in range(mix["warm_batches"]):
        s.to_host(s.predict(s.pool[:s.batch]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"set-up (s): tiles {t1 - t0:.2f}, model and weights "
          f"{t2 - t1:.2f}, warm batches {time.perf_counter() - t2:.2f}",
          file=sys.stderr)
    return s


def _next_indices(s):
    return s.draw.randint(0, len(s.pool), s.batch)


def _keep(s, k, idx, classes):
    """Reservoir sampling of `sample_batches` of the window's batches."""
    n = s.cell["traffic_spec"]["sample_batches"]
    if len(s.samples) < n:
        s.samples.append((k, idx, classes))
        return
    j = s.sampler.randint(0, k - s.window_first + 1)
    if j < n:
        s.samples[j] = (k, idx, classes)


def _loop(s, until, span, host=None, max_batches=None, keep=False):
    """Batches until the host clock passes `until` (or `max_batches`), the
    last one drained. Returns (images, latencies in ms)."""
    lat, images, prev, n = [], 0, None, 0
    while time.perf_counter() < until and n != max_batches:
        with span("inputs"):
            idx = _next_indices(s)
            xs = s.pool[idx]
        t = time.perf_counter()
        with span("predict"):
            out = s.predict(xs)
        if prev is not None:
            images += _drain(s, prev, span, lat, keep)
        prev = (s.k, idx, t, out)
        s.k += 1
        n += 1
    if prev is not None:
        images += _drain(s, prev, span, lat, keep)
    return images, lat


def _drain(s, prev, span, lat, keep):
    k, idx, t, out = prev
    with span("to_host"):
        classes = s.to_host(out)
    lat.append((time.perf_counter() - t) * 1e3)
    if keep:
        _keep(s, k, idx, classes)
    return len(classes)


def window(s, seconds: float, timed: bool):
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)
    s.window_first = s.k
    t0 = time.perf_counter()
    images, lat = _loop(s, t0 + seconds, no_span, keep=True)
    t1 = time.perf_counter()
    return {"seconds": t1 - t0, "images": images, "batches": len(lat),
            "batch_ms": lat, "dispatched": (s.k - s.window_first) * s.batch}


def profile(s, span):
    n = s.cell["traffic_spec"]["profile_batches"]
    _loop(s, float("inf"), span, max_batches=n)
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)
    return n


def program_outputs(s):
    return {"samples": s.samples, "pool": s.pool}


def release(s):
    s.model = s.predict = None
