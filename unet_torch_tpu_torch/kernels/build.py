"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with nvcc
for Hopper (sm_90a) into ``build/kernels/<name>-<hash>.so`` at the root of the
checkout, where ``<hash>`` covers the source, the shared ``csrc/*.cuh``
headers and the flags: an edited source or header builds anew, an unchanged
one is loaded as it is. Nothing is compiled when a module is imported; the
first launch builds, or ``build_all`` builds several sources at once.
The compiler's messages of each build (ptxas's registers and spills of every
kernel, the warnings) are kept beside the library; ``compile_log`` reads them.

A plain C interface keeps PyTorch's headers out of the compile (seconds
instead of minutes); pointers and the stream are passed as integers.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -split-compile 0 (nvcc 12.1 or newer): one source's kernels are optimised on
# all the host's cores, which shortens the longest of the parallel builds
# (the attention backward's template instances) by a third. -Xptxas -v: the
# registers and spills of every kernel go to the build's log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-split-compile", "0",
              "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built with the CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for this source exists.

    The ranks of a launch start together: one process builds a source while
    the others wait on its lock file (an flock, which the system drops when
    the holder exits) and then load what it built. The library is written
    to a temporary file and renamed into place, so no process loads a
    half-written file; its log is written first, so a library always has
    one."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            _compile(name, out)
    return out


def _compile(name: str, out: Path) -> None:
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_all(names) -> list[Path]:
    """``build`` each source, all nvcc processes running at once."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(build, names))


def compile_log(name: str) -> str:
    """What nvcc and ptxas said when ``csrc/<name>.cu`` was built: for each
    kernel its registers, stack and spills, and every warning."""
    return build(name).with_suffix(".log").read_text()


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu``; once per process."""
    return ctypes.CDLL(str(build(name)))
