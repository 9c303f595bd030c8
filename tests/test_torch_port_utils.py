"""The port's logging and debugging helpers (unet_torch_tpu_torch/utils):
MetricLogger and SmoothedValue (held equal to the JAX package's in
tests/test_torch_port_copies.py), check_input's batch grids and
profile_trace's Chrome trace on torch.profiler."""

import json

import numpy as np
import pytest
import torch

from unet_torch_tpu_torch.utils import (
    MetricLogger,
    SmoothedValue,
    check_input,
    profile_trace,
)


def test_smoothed_value_windows_and_totals():
    v = SmoothedValue(window_size=3)
    for x in (4.0, 1.0, 2.0, 8.0):
        v.update(x)
    assert v.value == 8.0 and v.max == 8.0
    assert v.median == 2.0 and v.avg == pytest.approx(11.0 / 3)
    assert v.global_avg == pytest.approx(15.0 / 4)
    assert str(v) == "2.0000 (3.7500)"


def test_metric_logger_logs_every_nth_iteration():
    lines = []
    logger = MetricLogger(print_fn=lines.append)
    for i in logger.log_every(range(5), 2, header="Epoch 1"):
        logger.update(loss=float(i), lr=0.1)
    assert logger.loss.value == 4.0
    assert [line.split("  ")[:2] for line in lines[:3]] == [
        ["Epoch 1", "[0/5]"], ["Epoch 1", "[2/5]"], ["Epoch 1", "[4/5]"]]
    assert "loss: " in lines[1] and "eta: " in lines[1]
    assert lines[-1].startswith("Epoch 1 Total time: ")
    with pytest.raises(AttributeError):
        logger.missing


def test_check_input_draws_the_first_train_and_val_batches(tmp_path,
                                                           capsys):
    pytest.importorskip("matplotlib")
    rng = np.random.RandomState(0)
    batch = (rng.rand(2, 16, 16, 3).astype(np.float32),
             rng.randint(0, 3, (2, 16, 16)).astype(np.float32))
    check_input({"train": [batch], "val": [(batch[0], (batch[1],))]},
                str(tmp_path))
    assert (tmp_path / "train_batch.png").stat().st_size > 0
    assert (tmp_path / "val_batch.png").stat().st_size > 0
    out = capsys.readouterr().out
    assert "train batch shapes: [(2, 16, 16, 3), (2, 16, 16)]" in out


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    assert prof is not None
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::relu" in names and "aten::mm" in names


@pytest.mark.parametrize("log_dir", [None, ""])
def test_profile_trace_without_a_directory_does_nothing(log_dir, tmp_path):
    with profile_trace(log_dir) as prof:
        torch.ones(2).sum()
    assert prof is None
