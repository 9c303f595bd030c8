"""Deterministic seeding (counterpart of unet_torch_tpu/core/rng.py).

Python and numpy are seeded globally for the host-side data pipeline, as in
the JAX package; torch randomness goes through the returned Generator, which
callers pass explicitly.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed host RNGs and return a CPU torch.Generator for the run."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
