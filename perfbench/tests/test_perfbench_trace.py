"""The traced sub-windows read back from hand-made chrome-trace events: the
device numbers from the device profile, bracketed by its opening and
closing fills, the idle gaps' labels from the host profile's spans."""

import pytest

from perfbench.core.trace import WINDOW, Trace


def op(name, cat, start_us, dur_us):
    return {"ph": "X", "name": name, "cat": cat, "ts": start_us,
            "dur": dur_us}


DEVICE = [op("fill", "kernel", 0, 1),  # opens the window
          op("gemm", "kernel", 10, 40), op("Memcpy HtoD", "gpu_memcpy", 30,
                                           30),
          op("cuda_runtime", "cuda_runtime", 5, 2),  # a host record: ignored
          op("fill", "kernel", 99, 1)]  # closes it
HOST = [op(WINDOW, "user_annotation", 1000, 100),
        op("loader.next", "user_annotation", 1000, 30),
        op("step", "user_annotation", 1030, 70),
        op("gemm", "kernel", 1040, 50)]


def test_device_numbers_come_from_the_device_profile():
    tr = Trace(DEVICE, HOST, units=2, host_s=1e-4)
    assert tr.window_s == pytest.approx(100e-6)
    # fills 1 + 1, gemm and copy overlapping over 10..60
    assert tr.busy_s == pytest.approx(52e-6)
    assert tr.seconds(lambda n: "HtoD" in n, cats=("gpu_memcpy",)) == \
        pytest.approx(30e-6)


def test_idle_gaps_are_labelled_by_the_host_profile_s_spans():
    tr = Trace(DEVICE, HOST, units=2, host_s=1e-4)
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert gaps["loader.next"] == pytest.approx(40e-6)  # 1000..1040
    assert gaps["step"] == pytest.approx(10e-6)  # 1090..1100
    ops = dict(tr.breakdown()["device_ops"])
    assert ops["gemm"] == pytest.approx(40e-6)


def test_a_profile_without_device_work_is_refused():
    with pytest.raises(RuntimeError):
        Trace([op("cuda_runtime", "cuda_runtime", 0, 1)], HOST, 1, 1.0)
