"""Cells of BENCHMARK.json cut to a size a CPU test run holds: the UNet at
base 8 on 64x64 tiles, the TransUnet at its widths on 64x64 tiles, batch
4 (2 for the TransUnet), few tiles; in float32 unless asked otherwise, so
that a sound run agrees with the reference to rounding. A cell taken out
of BENCHMARK.json whose files stay (PARKED) is read as if it were listed,
so that its check stays tested until it comes back."""

from __future__ import annotations

import tempfile
import time
from unittest import mock

import torch

from perfbench.core import harness, spec

# Out of BENCHMARK.json while the host paces its step (PERF.md, section 7).
PARKED = {"transunet_r50_b16.train": {
    "config": "transunet_r50_b16", "traffic": "train_loop", "chips": 1}}


def listed(name: str) -> dict:
    """spec.cell(name), a PARKED cell added to BENCHMARK.json's workloads
    where it is not there."""
    bench = spec.benchmark()
    if name in PARKED and all(w["name"] != name for w in bench["workloads"]):
        bench["workloads"].append(dict(PARKED[name], name=name))
    with mock.patch.object(spec, "benchmark", lambda: bench):
        return spec.cell(name)


def cell(name: str, precision: str = "f32"):
    c = listed(name)
    y = c["config_spec"]["yaml"]
    m = c["config_spec"]["model"]
    transunet = m.get("hidden_size") is not None
    y["model_config"]["input_size"] = [64, 64]
    m["img_size"] = 64
    if not transunet:
        y["model_config"]["initial_filter_size"] = [8]
        m["base"] = 8
    batch = 2 if transunet else 4
    y["train_config"]["batch_size"] = [batch]
    y["train_config"]["num_workers"] = 2
    y["train_config"]["precision"] = precision
    t = c["traffic_spec"]
    if t["kind"] == "train":
        t["tiles"] = 4 * batch
    else:
        t.update(pool=8, batch=batch, sample_batches=2, profile_batches=2)
    return c


def run(c, seed=2**31 + 17, fault=None, control=None, seconds=0.5):
    """(result, checks, numbers) of one run on the CPU."""
    return harness.run(c, seed, seconds, False, time.perf_counter(),
                       tempfile.mkdtemp(prefix="perfbench-test-"),
                       device=torch.device("cpu"), fault=fault,
                       control=control)
