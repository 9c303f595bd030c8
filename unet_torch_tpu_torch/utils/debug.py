"""Debugging helpers (counterpart of unet_torch_tpu/utils/debug.py).

check_input: the first train and val batches drawn as image grids,
`train_batch.png` and `val_batch.png` (the JAX package's, which needs
matplotlib: the card's machine has none).

profile_trace: a region under `torch.profiler`, the counterpart of the JAX
`jax.profiler.trace`: the host's operators and, where a card is there, its
kernels, written as a Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


def _to_grid(batch: np.ndarray) -> np.ndarray:
    """(B, H, W[, C]) -> one row of images, each scaled to [0, 1]."""
    batch = np.asarray(batch, np.float32)
    if batch.ndim == 3:
        batch = batch[..., None]
    b, h, w, c = batch.shape
    lo = batch.min(axis=(1, 2, 3), keepdims=True)
    hi = batch.max(axis=(1, 2, 3), keepdims=True)
    batch = (batch - lo) / np.maximum(hi - lo, 1e-6)
    grid = batch.transpose(1, 0, 2, 3).reshape(h, b * w, c)
    if c == 1:
        grid = np.repeat(grid, 3, axis=-1)
    return grid


def check_input(dataloaders, out_dir: str = ".") -> None:
    """Draw the first batch of `dataloaders["train"]` and `["val"]`: one row
    of images for each array of the batch with ndim >= 3 (images, label
    maps), into `<out_dir>/<phase>_batch.png`; print the arrays' shapes."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for phase in ("train", "val"):
        batch = next(iter(dataloaders[phase]))
        parts = []
        if isinstance(batch, (tuple, list)):
            for item in batch:
                if isinstance(item, (tuple, list)):
                    parts.extend(np.asarray(i) for i in item)
                else:
                    parts.append(np.asarray(item))
        else:
            parts = [np.asarray(batch)]
        print(f"{phase} batch shapes: {[p.shape for p in parts]}")
        rows = [_to_grid(p) for p in parts if p.ndim >= 3]
        fig, axs = plt.subplots(len(rows), 1,
                                figsize=(12, 3 * max(len(rows), 1)))
        if len(rows) == 1:
            axs = [axs]
        for ax, row in zip(axs, rows):
            ax.imshow(np.clip(row, 0, 1))
            ax.axis("off")
        fig.savefig(os.path.join(out_dir, f"{phase}_batch.png"))
        plt.close(fig)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """`with profile_trace(dir):` runs the region under torch.profiler (the
    card's activity too where CUDA is available) and writes
    `<dir>/trace.json`, a Chrome trace; yields the profiler. A falsy `dir`:
    nothing, and yields None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
