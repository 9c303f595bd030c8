"""What a run reads: the cell from BENCHMARK.json, its configuration's file,
its traffic mix's file and its limits' file, each found by name."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _read(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The workload `name` with its configuration, traffic and limits
    attached as `config_spec`, `traffic_spec` and `limits`, and the
    per-layer metrics reported in it as `per_layer`."""
    bench = benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    w = dict(found[0])
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    w["config_spec"] = _read(ROOT / conf["file"])
    w["traffic_spec"] = _read(BENCH / "traffic" / f"{w['traffic']}.json")
    w["limits"] = _read(BENCH / "limits" / f"{name}.json")
    w["end_to_end"] = [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])]
    w["per_layer"] = [m for m in bench["per_layer"]
                      if name in m.get("workloads", [name])]
    return w
