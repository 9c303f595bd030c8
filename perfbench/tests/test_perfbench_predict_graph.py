"""The reader of the share of the window's batches served by a CUDA graph
(perfbench/metrics/predict_graph_pct.py): the share against hand-made
tallies, None where the tally has no replay span or does not add up, and
None after a tiny CPU eval run, whose forward runs eagerly."""

import types

import pytest

from perfbench.core import harness
from perfbench.metrics import _spans
from perfbench.tests import tiny


def ctx(kind, **counts):
    return types.SimpleNamespace(kind=kind, counts=counts, trace=None)


def _predict_tally(setup, window, capture_at=(0,), replay=True):
    """A predict run's tally: `setup` untraced calls, then `window`, then 4
    traced ones; a capture at each call of `capture_at`, a replay at each
    other call where `replay` (an eager forward holds neither)."""
    ms, tally = 1_000_000, {}
    for k in range(setup + window + 4):
        traced = k >= setup + window
        tally.setdefault("predict.forward", []).append((ms, traced))
        if k in capture_at:
            tally.setdefault("predict.capture", []).append((500 * ms, traced))
        elif replay is True or k in replay:
            tally.setdefault("predict.replay", []).append((ms, traced))
    return tally


@pytest.mark.parametrize("tally,share", [
    (_predict_tally(3, 10), 100.0),
    # the window's forwards all eager, set-up's replayed
    (_predict_tally(3, 10, replay=(1, 2)), 0.0),
    # half the window's forwards eager
    (_predict_tally(3, 10, replay=(1, 2, 3, 5, 7, 9, 11)), 50.0),
    # a second key's capture in set-up
    (_predict_tally(3, 10, capture_at=(0, 2)), 100.0),
    # no replay span: an eager port, or the parent of the graphs
    (_predict_tally(3, 10, capture_at=(), replay=()), None),
    # tallies that do not add up are not cut to a share: more captures
    # than set-up's calls (one in the window), more replays than calls,
    # fewer replays than set-up's calls less its captures
    (_predict_tally(1, 10, capture_at=(0, 5)), None),
    ({**_predict_tally(3, 10), "predict.replay":
      _predict_tally(3, 10)["predict.replay"] + [(1_000_000, False)] * 2},
     None),
    (_predict_tally(3, 10, capture_at=(), replay=(1, 2)), None),
], ids=["all", "none", "half", "two_keys", "no_span", "window_capture",
        "extra_replays", "missing_replays"])
def test_the_graph_share_of_the_window_s_batches(monkeypatch, tally, share):
    monkeypatch.setattr(_spans, "port_tally", lambda: tally)
    read = harness.reader("predict_graph_pct")
    assert read(ctx("predict", batches=10)) == share
    assert read(ctx("predict", batches=20)) is None  # fewer forwards
    assert read(ctx("train", steps=10)) is None


def test_the_share_is_none_without_the_port_s_tally(monkeypatch):
    from unet_torch_tpu_torch.utils import debug

    monkeypatch.delattr(debug, "tally")
    assert harness.reader("predict_graph_pct")(ctx("predict", batches=3)) \
        is None


def test_a_tiny_cpu_eval_run_reads_no_share():
    """A CPU forward runs eagerly, so its tally holds no replay span."""
    from unet_torch_tpu_torch.utils import debug

    debug.reset_tally()
    c = tiny.cell("unet64_mc.eval")
    result, _, _ = tiny.run(c)
    assert result["correct"]
    n = result["attempted"] // c["traffic_spec"]["batch"]
    context = harness.Context(c, {"batches": n, "batch": 1}, 0.0)
    assert harness.reader("predict_dispatch_ms")(context) > 0
    assert harness.reader("predict_graph_pct")(context) is None
