"""A cell that brings its own driver. A traffic mix's `loop` names the loop
and check modules apart from its `kind`, the unit family that the metrics'
readers read. A toy train-family driver (a two-headed linear model fitted
by SGD, its check a float64 reference with the same state-dict names),
registered as perfbench.loops.toy_fit, perfbench.checks.toy_fit and
perfbench.reference.toy_fit, is added as a new cell the way a later PR adds
one: new files beside a copy of BENCHMARK.json to which entries and names
are only added (its configuration and workload, and its name in the
`workloads` lists of the train family's metrics). Read through spec.cell,
it runs through harness.run on the CPU and reports the train family's
metrics through the readers that are there; its own fault, found as
readings.py finds it, comes out not correct. The cells of
BENCHMARK.json keep their drivers."""

import copy
import importlib.util
import json
import sys
import tempfile
import time
import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from perfbench import checks, faults, loops, readings
from perfbench.checks import reference_model
from perfbench.core import flops, harness, spec, trace as tracelib, weights
from perfbench.core.trace import WINDOW, Trace, no_span
from perfbench.reference.ops import Ops

NAME = "toy_fit"
CELL = f"{NAME}.train"
FAMILY_OF = "unet64_mc.train"  # a train cell whose metrics the toy's are
ORIGINAL = spec.benchmark()
SIZE, CHANNELS, CLASSES = 4, 2, 3
FEATURES = SIZE * SIZE * CHANNELS
BATCH, ROWS, LR, CHECK_STEPS, PROFILE_STEPS = 4, 16, 0.1, 3, 4
SEED = 2**31 + 23


def data(seed: int):
    """(images NHWC, class labels, points) of the toy's train set."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(ROWS, SIZE, SIZE, CHANNELS, generator=g),
            torch.randint(0, CLASSES, (ROWS,), generator=g),
            torch.rand(ROWS, 2, generator=g))


def loss_of(out, labels, points):
    return F.cross_entropy(out[0], labels) + F.mse_loss(out[1], points)


class Program(nn.Module):
    def __init__(self):
        super().__init__()
        self.head = nn.Linear(FEATURES, CLASSES)
        self.points = nn.Linear(FEATURES, 2)

    def forward(self, x):
        f = x.flatten(1)
        return self.head(f), self.points(f)


class Reference(Program):
    """The plain reference: the program's state-dict names, every product
    through `ops`, logits and points returned."""

    def forward(self, x, ops, train=False):
        f = x.flatten(1)
        return (ops.linear(f, self.head.weight, self.head.bias),
                ops.linear(f, self.points.weight, self.points.bias))


def train_step(model, opt, x, labels, points):
    opt.zero_grad()
    loss = loss_of(model(x), labels, points)
    loss.backward()
    opt.step()
    return loss.detach()


def unchanged(step):
    """The toy's own fault: the step leaves the model as it was."""
    def broken(model, opt, x, labels, points):
        before = [p.detach().clone() for p in model.parameters()]
        loss = step(model, opt, x, labels, points)
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), before):
                p.copy_(p0)
        return loss
    return broken


def loop_module():
    mod = _module("loops")
    mod.FAULTS = {"unchanged": unchanged}
    mod.SETUPS, mod.STEPS = [], []

    def step(s, span, host=None):
        t0 = time.perf_counter()
        with span("loader.next"):
            rows = slice(s.k * BATCH % ROWS, s.k * BATCH % ROWS + BATCH)
        t1 = time.perf_counter()
        with span("trainer.to_device"):
            batch = [t[rows].to(s.device) for t in (s.x, s.labels, s.pts)]
        with span("step"):
            loss = s.step(s.model, s.opt, *batch)
        if host is not None:
            host["data_wait_s"] += t1 - t0
            host["dispatch_s"] += time.perf_counter() - t1
        s.k += 1
        return float(loss)

    def setup(cell, seeds, device, workdir, fault=None):
        mod.SETUPS.append(cell["name"])
        s = types.SimpleNamespace(device=device, batch=BATCH, k=0,
                                  epoch_losses=[])
        s.x, s.labels, s.pts = data(seeds["data"])
        with torch.device("meta"):
            model = Program()
        s.model = weights.materialize(model, seeds["weights"], device)
        s.opt = torch.optim.SGD(s.model.parameters(), lr=LR)
        s.step = train_step if fault is None else fault(train_step)
        s.check_losses = [step(s, no_span) for _ in range(CHECK_STEPS)]
        s.after = {n: p.detach().clone()
                   for n, p in s.model.named_parameters()}
        return s

    def window(s, seconds, timed):
        host = {"data_wait_s": 0.0, "dispatch_s": 0.0} if timed else None
        ends, losses = [time.perf_counter()], []
        while ends[-1] < ends[0] + seconds:
            losses.append(step(s, no_span, host))
            ends.append(time.perf_counter())
        s.epoch_losses.append(sum(losses) / len(losses))
        mod.STEPS.append(len(losses))
        return {"seconds": ends[-1] - ends[0], "steps": len(losses),
                "images": len(losses) * BATCH,
                "step_ms": [1e3 * (b - a) for a, b in zip(ends, ends[1:])],
                **(host or {})}

    def profile(s, span):
        for _ in range(PROFILE_STEPS):
            step(s, span)
        return PROFILE_STEPS

    def program_outputs(s):
        return {"losses": s.check_losses, "params": s.after,
                "epoch_losses": s.epoch_losses}

    def release(s):
        s.model = s.opt = None

    for f in (setup, window, profile, program_outputs, release):
        setattr(mod, f.__name__, f)
    return mod


def check_module():
    mod = _module("checks")

    def check(cell, seeds, outputs, device, workdir, control=None):
        """The reference's first steps in float64 from the same weights:
        the largest gap of a step's loss and of a parameter after them."""
        model = reference_model.build(cell, seeds["weights"],
                                      device).double()
        x, labels, pts = data(seeds["data"])
        losses = []
        for k in range(CHECK_STEPS):
            rows = slice(k * BATCH, (k + 1) * BATCH)
            loss = loss_of(model(x[rows].double(), Ops("f64")), labels[rows],
                           pts[rows].double())
            grads = torch.autograd.grad(loss, list(model.parameters()))
            with torch.no_grad():
                for p, g in zip(model.parameters(), grads):
                    p -= LR * g
            losses.append(float(loss.detach()))
        return {"loss_gap": max(abs(a - b) for a, b in
                                zip(outputs["losses"], losses)),
                "param_gap": max(float((outputs["params"][n].double()
                                        - p.detach()).abs().max())
                                 for n, p in model.named_parameters())}

    mod.check = check
    return mod


def reference_module():
    mod = _module("reference")
    mod.build = lambda spec: Reference()
    return mod


def _module(package):
    name = f"perfbench.{package}.{NAME}"
    mod = types.ModuleType(name)
    mod.__spec__ = importlib.util.spec_from_loader(name, loader=None)
    return mod


def added_benchmark(listed=True):
    """BENCHMARK.json with the toy's configuration and workload added and,
    where `listed`, its name added to the `workloads` of every metric that
    FAMILY_OF reports: additions alone, as a later PR's."""
    bench = copy.deepcopy(ORIGINAL)
    bench["configs"].append({
        "name": NAME, "source": "https://arxiv.org/abs/2202.13065",
        "file": f"perfbench/configs/{NAME}.json", "reduced": [],
        "why": "a toy of a point detector's two heads"})
    bench["workloads"].append({
        "name": CELL, "config": NAME, "traffic": f"{NAME}_loop", "chips": 1,
        "why": "a toy train-family driver of its own"})
    if listed:
        for m in bench["end_to_end"] + bench["per_layer"]:
            if FAMILY_OF in m.get("workloads", ()):
                m["workloads"].append(CELL)
    return bench


def _only_adds(old, new):
    """`new` is `old` with entries and list items added, nothing changed."""
    if isinstance(old, dict):
        return old.keys() == new.keys() and all(
            _only_adds(old[k], new[k]) for k in old)
    if isinstance(old, list):
        return len(new) >= len(old) and all(
            _only_adds(a, b) for a, b in zip(old, new))
    return old == new


@pytest.fixture
def toy(monkeypatch, tmp_path):
    """The toy's loop module, with its check and reference registered and
    spec reading a checkout that holds the toy's files and an added-to
    BENCHMARK.json."""
    mod = loop_module()
    for package, module in (("loops", mod), ("checks", check_module()),
                            ("reference", reference_module())):
        monkeypatch.setitem(sys.modules, module.__name__, module)
    root = tmp_path / "checkout"
    for sub in ("configs", "traffic", "limits"):
        (root / "perfbench" / sub).mkdir(parents=True)
    _write(root / "BENCHMARK.json", added_benchmark())
    _write(root / "perfbench" / "configs" / f"{NAME}.json",
           {"reference": NAME,
            "model": {"img_size": SIZE, "in_channels": CHANNELS}})
    _write(root / "perfbench" / "limits" / f"{CELL}.json",
           {"numbers": {"loss_gap": {"limit": 1e-5},
                        "param_gap": {"limit": 1e-5}}})
    monkeypatch.setattr(spec, "ROOT", root)
    monkeypatch.setattr(spec, "BENCH", root / "perfbench")
    return mod


def _write(path, obj):
    path.write_text(json.dumps(obj))


def toy_cell(kind="train"):
    """The toy's cell as spec.cell reads it, its mix of `kind`."""
    _write(spec.BENCH / "traffic" / f"{NAME}_loop.json",
           {"kind": kind, "loop": NAME})
    return spec.cell(CELL)


def run(c, trace=False, fault=None, workdir=None):
    return harness.run(c, SEED, 0.2, trace, time.perf_counter(),
                       workdir or tempfile.mkdtemp(prefix="perfbench-test-"),
                       device=torch.device("cpu"), fault=fault)


def reported(entries):
    """The names of the metrics among `entries` that FAMILY_OF reports."""
    return {m["name"] for m in entries
            if FAMILY_OF in m.get("workloads", [FAMILY_OF])}


def test_the_toy_cell_only_adds_to_benchmark_json(toy):
    bench = spec.benchmark()
    assert bench != ORIGINAL and _only_adds(ORIGINAL, bench)
    c = toy_cell()
    assert {m["name"] for m in c["end_to_end"]} == reported(
        ORIGINAL["end_to_end"]) == {"train_img_s", "train_step_p95_ms",
                                    "setup_s"}
    assert {m["name"] for m in c["per_layer"]} == reported(
        ORIGINAL["per_layer"])


def test_a_cell_named_in_no_metric_s_workloads_reports_set_up_alone(toy):
    _write(spec.ROOT / "BENCHMARK.json", added_benchmark(listed=False))
    result, checks_, _ = run(toy_cell())
    assert result["correct"], checks_
    assert set(result["metrics"]) == {"setup_s"}


def test_a_driver_of_its_own_reports_the_train_family(toy):
    result, checks_, numbers = run(toy_cell())
    assert toy.SETUPS == [CELL]
    assert result["correct"], checks_
    assert set(checks_) == {"loss_gap", "param_gap"}
    assert numbers["param_gap"] < 1e-6
    assert result["attempted"] == toy.STEPS[0] > 0
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"train_img_s", "train_step_p95_ms",
                                      "setup_s"}
    assert result["metrics"]["train_img_s"]["unit"] == "img/s"


def _op(name, cat, start_us, dur_us):
    return {"ph": "X", "name": name, "cat": cat, "ts": start_us,
            "dur": dur_us}


def test_its_traced_run_reports_the_train_family_s_per_layer_metrics(
        toy, monkeypatch):
    """The profiles of a CPU run are hand-made (the device profile needs a
    card); the loop's own profile runs under them."""
    def fake(profile_fn, workdir):
        units = profile_fn(no_span)
        device = [_op("fill", "kernel", 0, 1), _op("gemm", "kernel", 10, 4),
                  _op("fill", "kernel", 99, 1)]
        host = [_op(WINDOW, "user_annotation", 0, 100),
                _op("step", "user_annotation", 0, 100),
                _op("step.forward", "user_annotation", 0, 50),
                _op("gemm", "kernel", 60, 10)]
        return Trace(device, host, units, host_s=1e-4)

    monkeypatch.setattr(tracelib, "run", fake)
    result, checks_, _ = run(toy_cell(), trace=True)
    assert result["correct"], checks_
    assert {"train_data_wait_ms", "train_dispatch_ms", "idle_pct.train",
            "mfu.train", "idle_dispatch_pct.train"} <= set(result["metrics"])
    assert set(result["metrics"]) <= reported(ORIGINAL["per_layer"])
    assert result["breakdown"]["idle_gaps"][0][0] == "step"


def test_a_reference_s_work_counts_every_tensor_it_returns(toy):
    forward = 2 * FEATURES * (CLASSES + 2)  # both heads, an image
    conf = toy_cell()["config_spec"]
    assert flops.count(conf, train=False)[0] == forward
    # the input needs no gradient: the weights' gradients of both heads
    assert flops.count(conf, train=True)[0] == 2 * forward


def test_the_driver_s_own_fault_is_not_correct(toy):
    c = toy_cell()
    fault = loops.fault(c["traffic_spec"], "unchanged")
    assert fault is unchanged
    assert readings.plan(c, "unchanged") == (unchanged, None, None)
    result, checks_, _ = run(c, fault=fault)
    assert not result["correct"], checks_
    assert checks_["param_gap"]["value"] > 1e-3


@pytest.mark.parametrize("mode", ["look", "no_such_mode", "half_batch",
                                  "altered"])
def test_readings_refuse_a_mode_the_cell_s_driver_lacks(toy, mode):
    """Another driver's step takes none of loops/train.py's or
    loops/predict.py's faults."""
    with pytest.raises(SystemExit):
        readings.plan(toy_cell(), mode)


@pytest.mark.parametrize("kind", ["serve", None])
def test_a_mix_of_no_unit_family_fails_before_set_up(toy, tmp_path, kind):
    workdir = tmp_path / "run"
    workdir.mkdir()
    with pytest.raises(ValueError, match="'train' or 'predict'"):
        run(toy_cell(kind), workdir=str(workdir))
    assert toy.SETUPS == [] and not workdir.exists()


def test_a_driver_without_a_check_fails_before_set_up(toy, tmp_path,
                                                      monkeypatch):
    monkeypatch.delitem(sys.modules, f"perfbench.checks.{NAME}")
    workdir = tmp_path / "run"
    workdir.mkdir()
    with pytest.raises(ModuleNotFoundError, match=f"checks.{NAME}"):
        run(toy_cell(), workdir=str(workdir))
    assert toy.SETUPS == [] and not workdir.exists()


@pytest.mark.parametrize("name", ["unet64_mc.train", "unet64_mc.eval",
                                  "transunet_r50_b16.eval"])
def test_the_benchmark_s_cells_keep_their_drivers(name):
    c = spec.cell(name)
    family = name.rsplit(".", 1)[1].replace("eval", "predict")
    mix = c["traffic_spec"]
    assert "loop" not in mix and loops.family(mix) == family
    driver = loops.driver(mix)
    assert loops.loop(driver).__name__ == f"perfbench.loops.{family}"
    assert checks.checker(driver).__name__ == f"perfbench.checks.{family}"
    own = {"train": {"unchanged": faults.unchanged,
                     "half_batch": faults.half_batch},
           "predict": {"altered": faults.altered}}[family]
    assert loops.loop(driver).FAULTS == own
    for mode, wrapper in own.items():
        assert loops.fault(mix, mode) is wrapper
    fault, control, check = readings.plan(c, "control")
    assert (fault, control) == (None, "fp8")
    assert (check is None) == (family == "predict")
