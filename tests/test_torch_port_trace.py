"""The port's spans (unet_torch_tpu_torch/utils/debug.py::span): each call's
host time in the tally, tagged traced or not, from any thread, in a bounded
buffer; a `record_function` range only while a profiler records; and the
spans of the loader, the batch copy, the train step and predict, each
opened where its work happens and as often as the work runs."""

import json
import sys
import threading
import types

import numpy as np
import pytest
import torch

from unet_torch_tpu_torch.core.mesh import shard_batch
from unet_torch_tpu_torch.data.loader import NumpyLoader
from unet_torch_tpu_torch.eval.reports import _to_host, make_predict_fn
from unet_torch_tpu_torch.models.unet import UNet
from unet_torch_tpu_torch.train.optim import make_optimizer
from unet_torch_tpu_torch.train.steps import make_single_steps
from unet_torch_tpu_torch.utils import debug
from unet_torch_tpu_torch.utils.debug import (
    profile_trace,
    reset_tally,
    span,
    tally,
)


@pytest.fixture(autouse=True)
def empty_tally():
    reset_tally()
    yield
    reset_tally()


def counts():
    return {name: len(calls) for name, calls in tally().items()}


def test_a_span_without_a_profiler_is_tallied_untraced_and_opens_no_range(
        monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    with span("test.plain"):
        sum(range(1000))
    [(ns, traced)] = tally()["test.plain"]
    assert ns > 0 and traced is False
    assert opened == []


def test_a_span_under_profile_trace_is_traced_and_in_the_chrome_trace(
        tmp_path):
    with profile_trace(str(tmp_path)):
        with span("test.traced"):
            torch.relu(torch.randn(32, 32) @ torch.randn(32, 32))
    [(ns, traced)] = tally()["test.traced"]
    assert ns > 0 and traced is True
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert [e["cat"] for e in events
            if e.get("name") == "test.traced"] == ["user_annotation"]


def test_four_threads_tally_every_call():
    """Four threads of 1000 spans each under a short switch interval, with
    the tally copied meanwhile: no call is lost."""
    names = ["test.thread", "test.shared"]
    copies = []

    def work(i):
        for j in range(1000):
            with span(names[j % 2]):
                pass
            if i == 0 and j % 100 == 0:
                copies.append(tally())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counts() == {"test.thread": 2000, "test.shared": 2000}
    assert len(copies) == 10
    assert not any(traced for calls in tally().values()
                   for _, traced in calls)


def test_the_bounded_buffer_keeps_the_newest_calls(monkeypatch):
    # span k reads the clock at 0 when it opens and at k when it closes
    clock = iter([v for k in range(10) for v in (0, k)])
    monkeypatch.setattr(debug, "time",
                        types.SimpleNamespace(perf_counter_ns=clock.__next__))
    monkeypatch.setattr(debug, "TALLY_CALLS", 4)
    for _ in range(10):
        with span("test.bounded"):
            pass
    assert [ns for ns, _ in tally()["test.bounded"]] == [6, 7, 8, 9]


class _Samples:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((4, 4, 3), i, np.float32),
                np.full((4, 4), i % 3, np.int32))


@pytest.mark.parametrize("num_workers", [0, 2])
def test_numpy_loader_spans_a_fetch_a_batch_and_a_get_a_batch_and_epoch(
        num_workers):
    loader = NumpyLoader(_Samples(5), 2, shuffle=True, seed=3,
                         num_workers=num_workers)
    epochs = [list(loader) for _ in range(2)]
    assert [len(batches) for batches in epochs] == [3, 3]
    assert counts() == {"loader.fetch": 6, "loader.get": 6 + 2}


def test_a_cpu_train_step_opens_each_step_span_once_in_order(tmp_path):
    torch.manual_seed(0)
    model = UNet(3, 3, base=8)
    opt = make_optimizer("Adam", model.parameters(), 1e-3, 1e-4)
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", 3)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 3, (2, 32, 32))
    with profile_trace(str(tmp_path)):
        loss = step(model, opt, x, y, 1e-3, None)
    assert torch.isfinite(loss)
    phases = ["step.forward", "step.backward", "step.optimizer"]
    assert counts() == dict.fromkeys(phases, 1)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    starts = {e["name"]: e["ts"] for e in events
              if e.get("cat") == "user_annotation" and e["name"] in phases}
    assert sorted(starts, key=starts.get) == phases


def test_predict_and_to_host_open_each_predict_span_once_a_batch():
    torch.manual_seed(0)
    predict = make_predict_fn(UNet(3, 3, base=8), "cpu", torch.float32,
                              classes=True)
    rng = np.random.RandomState(0)
    for _ in range(3):
        classes = _to_host(predict(rng.randn(2, 32, 32, 3).astype(
            np.float32)))
        assert classes.shape == (2, 32, 32) and classes.dtype == np.uint8
    assert counts() == {"predict.h2d": 3, "predict.forward": 3,
                        "predict.to_host": 3}
    assert not any(traced for calls in tally().values()
                   for _, traced in calls)


@pytest.mark.parametrize("model_type,flags", [
    ("single", {"classes": True}), ("single", {"binary": True}),
    ("multi_task", {})], ids=["classes", "binary", "two_heads"])
def test_predict_on_the_cpu_is_the_eager_forward_without_a_graph(model_type,
                                                                 flags):
    """The CPU forward runs eagerly: each result is the model's output and
    postprocess on the batch as `.to(dtype)` casts it, and no call opens a
    capture or replay span."""
    from unet_torch_tpu_torch.eval.metrics import class_argmax
    from unet_torch_tpu_torch.eval.reports import sigmoid_mask
    from unet_torch_tpu_torch.models.unet import build_model

    model = build_model(model_type, n_channels=3, n_classes=2, base=8,
                        generator=torch.Generator().manual_seed(0))
    predict = make_predict_fn(model, "cpu", torch.bfloat16, **flags)
    rng = np.random.RandomState(1)
    for _ in range(2):
        xs = rng.randn(2, 16, 16, 3).astype(np.float32)
        got = predict(xs)
        with torch.inference_mode():
            want = model(torch.from_numpy(xs).to(torch.bfloat16))
            if flags.get("classes"):
                want = class_argmax(want)
            elif flags.get("binary"):
                want = sigmoid_mask(want)
        if model_type == "multi_task":
            assert len(got) == len(want) == 2
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        else:
            assert torch.equal(got, want)
    assert counts() == dict.fromkeys(["predict.h2d", "predict.forward"], 2)


def test_shard_batch_on_the_cpu_opens_no_pin_span():
    x = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    y = np.zeros((2, 4, 4), np.int32)
    tx, ty = shard_batch((x, y), "cpu", torch.bfloat16)
    assert tx.dtype == torch.bfloat16 and ty.dtype == torch.int32
    np.testing.assert_array_equal(tx.float().numpy(), x)
    assert "batch.pin" not in tally()
