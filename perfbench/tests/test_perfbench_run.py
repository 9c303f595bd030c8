"""run.py refuses to run without a card, and without the program."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "unet64_mc.train", "--seed", "4294967311",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or "correct" not in lines[-1]


def test_the_benchmark_file_names_every_piece():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert (ROOT / "perfbench" / "metrics" / f"{name}.py").is_file()
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "unet64_mc.eval",
         "--seed", "4294967311", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
