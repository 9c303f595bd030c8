"""The readers of the port's spans (perfbench/metrics/_spans.py): the
measured window's calls taken from a hand-made tally, None where the port
has no tally, the idle share inside the port's spans against the same
trace's breakdown, and each reader after a tiny CPU run of each kind."""

import types

import pytest

from perfbench.core import harness
from perfbench.core.trace import WINDOW, Trace
from perfbench.metrics import _spans
from perfbench.tests import tiny

TRAIN = ["loader_wait_ms", "loader_fetch_ms", "train_pin_ms",
         "train_forward_ms", "train_backward_ms", "train_optimizer_ms"]
EVAL = ["predict_h2d_host_ms", "predict_dispatch_ms", "predict_wait_ms"]
IDLE = ["idle_dispatch_pct.train", "idle_dispatch_pct.eval"]


def ctx(kind, trace=None, **counts):
    return types.SimpleNamespace(kind=kind, counts=counts, trace=trace)


def test_the_window_is_the_last_untraced_calls(monkeypatch):
    ms = 1_000_000
    calls = ([(100 * ms, False)] * 5  # set-up
             + [(k * ms, False) for k in (2, 4, 6)]  # the window
             + [(50 * ms, True)] * 4)  # the two profiles
    monkeypatch.setattr(_spans, "port_tally",
                        lambda: {"step.forward": calls})
    read = harness.reader("train_forward_ms")
    assert read(ctx("train", steps=3)) == pytest.approx(4.0)
    assert read(ctx("train", steps=9)) is None  # fewer calls than steps
    assert read(ctx("predict", batches=3)) is None
    assert harness.reader("train_backward_ms")(ctx("train", steps=3)) is None


def test_every_reader_is_none_without_the_port_s_tally(monkeypatch):
    from unet_torch_tpu_torch.utils import debug

    monkeypatch.delattr(debug, "tally")
    for name in TRAIN:
        assert harness.reader(name)(ctx("train", steps=3)) is None
    for name in EVAL:
        assert harness.reader(name)(ctx("predict", batches=3)) is None


def op(name, cat, start_us, dur_us):
    return {"ph": "X", "name": name, "cat": cat, "ts": start_us,
            "dur": dur_us}


DEVICE = [op("fill", "kernel", 0, 1), op("fill", "kernel", 99, 1)]


def test_the_idle_share_inside_the_port_s_spans_against_the_breakdown():
    # idle: 0..10 (loader.next), 30..40 (step.forward), 60..70 (inside
    # step, no port span), 80..100 (step.optimizer)
    host = [op(WINDOW, "user_annotation", 0, 100),
            op("loader.next", "user_annotation", 0, 20),
            op("step", "user_annotation", 20, 80),
            op("step.forward", "user_annotation", 25, 20),
            op("step.optimizer", "user_annotation", 75, 25),
            op("gemm", "kernel", 10, 20), op("gemm", "kernel", 40, 20),
            op("gemm", "kernel", 70, 10)]
    tr = Trace(DEVICE, host, units=1, host_s=1e-4)
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"loader.next": 10e-6, "step": 40e-6})
    share = harness.reader("idle_dispatch_pct.train")(ctx("train", tr))
    assert share == pytest.approx(100 * 30 / 50)
    assert share <= 100 * gaps["step"] / sum(gaps.values())
    assert harness.reader("idle_dispatch_pct.eval")(ctx("train", tr)) is None
    # the host profile of a port without spans
    bare = Trace(DEVICE, host[:3] + host[5:], units=1, host_s=1e-4)
    assert harness.reader("idle_dispatch_pct.train")(ctx("train", bare)) \
        is None
    assert harness.reader("idle_dispatch_pct.train")(ctx("train")) is None


@pytest.mark.parametrize("name", ["unet64_mc.train", "unet64_mc.eval"])
def test_each_reader_reads_a_tiny_cpu_run(name):
    from unet_torch_tpu_torch.utils import debug

    debug.reset_tally()
    c = tiny.cell(name)
    result, _, _ = tiny.run(c)
    assert result["correct"]
    n = result["attempted"]
    if c["traffic_spec"]["kind"] == "train":
        counts, names = {"steps": n}, TRAIN
    else:
        counts, names = {"batches": n // c["traffic_spec"]["batch"]}, EVAL
    context = harness.Context(c, dict(counts, batch=1), 0.0)
    values = {m: harness.reader(m)(context) for m in names}
    for m, v in values.items():
        if m == "train_pin_ms":  # a CPU pins nothing
            assert v is None
        else:
            assert v is not None and v > 0, (m, v)
