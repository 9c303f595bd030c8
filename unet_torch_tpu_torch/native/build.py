"""Build the port's host C++ sources and load them with ctypes (the port's
copy of unet_torch_tpu/native/build.py).

``native/<name>.cpp`` is compiled with g++ into
``build/native/lib<name>-<hash>.so`` at the root of the checkout, where
``<hash>`` covers the source and the flags: an edited source builds anew, an
unchanged one is loaded as it is. Nothing is built next to the source, and
nothing when a module is imported. A build or load that fails raises; no
caller falls back to the numpy version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def build_shared(name: str) -> Path:
    """Compile ``native/<name>.cpp`` unless its library exists; returns the
    library's path. The library is written to a temporary file and renamed
    into place, so processes that build at the same time never load a
    half-written file. The ``lib`` prefix keeps it out of Python's import
    resolution."""
    src = SRC / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``native/<name>.cpp``; once per process."""
    return ctypes.CDLL(str(build_shared(name)))
