"""ctypes bindings of the persistent-homology and union-find extension
(the port's copy of unet_torch_tpu/native/ph0.py; ph0.cpp is the original's
source, unchanged). ctypes releases the GIL for the whole C call, so a
pairing in a worker thread runs beside the main thread."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from unet_torch_tpu_torch.native import build


@functools.cache
def _load() -> ctypes.CDLL:
    lib = build.load("ph0")
    lib.superlevel_ph0.restype = ctypes.c_int
    lib.superlevel_ph0.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.count_components.restype = ctypes.c_int
    lib.count_components.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
    return lib


def superlevel_ph0(img: np.ndarray, max_bars: int):
    """Drop-in for losses.topo._superlevel_ph0_np (same contract, equal
    output)."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape
    births = np.zeros(max_bars, np.int32)
    deaths = np.zeros(max_bars, np.int32)
    n = lib.superlevel_ph0(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, max_bars,
        births.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        deaths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return births, deaths, np.int32(n)


def count_components(mask: np.ndarray) -> int:
    """Connected components (8-connectivity) of a binary mask."""
    lib = _load()
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    return int(lib.count_components(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w))
