"""What a run checks and sets about where it runs: the build caches inside
the checkout, the card, the modules it may not have loaded, the device's
description, and the last lines it prints."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from perfbench.core.spec import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "unet_torch_tpu")


def set_caches():
    """Every build and kernel cache at a fixed path inside the checkout.
    The port builds its CUDA kernels into `build/kernels/` of the
    checkout itself."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def require_cards(n: int):
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is visible: the benchmark measures the "
                 "port on an H100 and prints no result without one")
    if torch.cuda.device_count() < n:
        sys.exit(f"the cell needs {n} CUDA devices, "
                 f"{torch.cuda.device_count()} are visible")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one that no run may load,
    compared whole (`unet_torch_tpu_torch` is not `unet_torch_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device(count: int, peak: int, trace=None) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(peak)}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def emit(result: dict, checks: dict):
    """The numbers compared, beside their limits, as the last lines on
    standard error; the result as the last line on standard output, with
    the same numbers under `checks`, its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
