"""The look at where the train cells' worst leaves come from, on the CPU at
a tiny size: beside a bfloat16 program, the bfloat16 witness reads gaps of
the program's order and the float64 witness lies far closer to the
float32 reference; each GroupNorm's gradient terms are read."""

import tempfile
import time

import torch

from perfbench import readings
from perfbench.core import harness
from perfbench.tests import tiny


def test_the_look_reads_both_witnesses_and_the_cancellation():
    cell = tiny.cell("transunet_r50_b16.train", "bf16")
    cell["limits"]["numbers"] = {}
    _, _, numbers = harness.run(
        cell, 2**31 + 99, 0.5, False, time.perf_counter(),
        tempfile.mkdtemp(prefix="perfbench-test-"),
        device=torch.device("cpu"), check=readings.train_check(True))
    look = numbers["look"]
    bf16 = look["bf16"]["numbers"]["grad_gap_median"]
    f64 = look["f64"]["numbers"]["grad_gap_median"]
    assert f64 < 1e-3 < bf16
    assert numbers["grad_gap_median"] > 10 * f64
    ratios = look["cancellation"]
    assert ratios["median_gn"] > 1.0
    assert all(r is not None and r >= 1.0 for r, _ in ratios["grad"])


def test_leaf_gaps_are_against_the_larger_of_the_leaf_and_the_median():
    ref = {"a": 1.0, "b": 2.0, "c": 0.01}
    gaps = readings.leaf_gaps({"a": 1.5, "b": 2.0, "c": 0.02}, ref, ref)
    assert gaps == {"a": 0.5, "b": 0.0, "c": 0.01}
    assert readings.worst_leaves(gaps, 1) == [[0.5, "a"]]


def test_the_whole_model_s_norm_gap_and_the_median_leaf_s():
    from perfbench.checks import train

    ref = {"a": 3.0, "b": 4.0, "c": 1.0}
    prog = {"a": 3.0, "b": 4.0, "c": 1.0 + 2e-3}
    # |(9 + 16 + 1.002^2) ** 0.5 - 26 ** 0.5| / 26 ** 0.5
    want = abs((25 + 1.002 ** 2) ** 0.5 - 26 ** 0.5) / 26 ** 0.5
    assert abs(train.total_gap(prog, ref, ref) - want) < 1e-12
    assert train.median_gap(prog, ref, ref) == 0.0
    assert train.total_gap({"a": float("nan"), "b": 4.0, "c": 1.0}, ref,
                           ref) == float("inf")
