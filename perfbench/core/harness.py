"""One run of one cell: set-up, the measured window, the traced sub-window
with `trace`, the device's peak memory, the program released, the check
against the plain reference, and the metrics read by their own readers
(perfbench/metrics/<name>.py), found by the names in BENCHMARK.json."""

from __future__ import annotations

import importlib.util
import math
import shutil
import sys
import time

import torch

from perfbench import loops
from perfbench.checks import checker, judge, require
from perfbench.core import env, flops, seeds as seedlib, trace as tracelib
from perfbench.core.spec import BENCH


class Context:
    """What a metric's reader may read."""

    def __init__(self, cell, counts, setup_s, trace=None):
        self.cell = cell
        self.spec = cell["config_spec"]
        self.kind = cell["traffic_spec"]["kind"]
        self.counts = counts
        self.setup_s = setup_s
        self.trace = trace
        self.batch = counts["batch"]

    def work(self, train: bool):
        """(FLOPs an image, the reference's recorded calls an image)."""
        return flops.count(self.spec, train)


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries, ctx) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def run(cell, seed: int, seconds: float, trace: bool, start: float,
        workdir: str, device=None, fault=None, control=None, check=None):
    """(result without `checks`, checks, every number the check read).
    The mix's driver runs the cell and its check judges it; a mix of no
    unit family fails before set-up. `fault` wraps the timed path's call
    (tests and fault readings only); `control` judges the reference in that
    precision in the program's place (control readings only); `check`
    stands in for the check of the mix's loop (readings only)."""
    device = device or torch.device("cuda", 0)
    seeds = seedlib.derive(seed)
    try:
        mix = cell["traffic_spec"]
        kind, name = loops.family(mix), loops.driver(mix)
        drv = loops.loop(name)
        if check is None:
            require(name)
        print(f"imports (s): {time.perf_counter() - start:.2f}",
              file=sys.stderr)
        state = drv.setup(cell, seeds, device, workdir, fault)
        setup_s = time.perf_counter() - start
        counts = drv.window(state, seconds, timed=trace)
        counts["batch"] = state.batch
        tr = None
        if trace:
            tr = tracelib.run(lambda span: drv.profile(state, span), workdir)
            unit = counts.get("steps", counts.get("batches")) or 1
            print(f"ms a unit: window {1e3 * counts['seconds'] / unit:.2f},"
                  f" device profile {1e3 * tr.host_s / tr.units:.2f}, host "
                  f"profile {1e3 * tr.host_window_s / tr.units:.2f}",
                  file=sys.stderr)
        cuda = device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        outputs = drv.program_outputs(state)
        drv.release(state)
        del state
        if cuda:
            torch.cuda.empty_cache()
        numbers = (check or checker(name).check)(cell, seeds, outputs,
                                                 device, workdir, control)
        checks, ok = judge(numbers, cell["limits"])
        if kind == "train":
            attempted = counts["steps"]
            bad = [v for v in outputs["epoch_losses"] if not math.isfinite(v)]
            failed = attempted if bad else 0
        else:
            attempted = counts["dispatched"]
            failed = attempted - counts["images"]
        ctx = Context(cell, counts, setup_s, tr)
        entries = cell["per_layer"] if trace else cell["end_to_end"]
        result = {"correct": bool(ok and failed == 0),
                  "attempted": attempted, "failed": failed,
                  "metrics": read_metrics(entries, ctx),
                  "device": (env.device(cell["chips"], peak, tr) if cuda
                             else {"platform": "cpu"})}
        if tr is not None:
            result["breakdown"] = tr.breakdown()
        checks = {k: {"value": _finite(v["value"]),
                      "limit": v["limit"]} for k, v in checks.items()}
        return result, checks, numbers
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
