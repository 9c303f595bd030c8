"""The reference model of a configuration, on a device with the seed's
weights, its products in float32 with TF32 off."""

from __future__ import annotations

import importlib

import torch

from perfbench.core import weights


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def build(cell, weight_seed: int, device):
    spec = cell["config_spec"]
    module = importlib.import_module(
        f"perfbench.reference.{spec['reference']}")
    with torch.device("meta"):
        model = module.build(spec)
    return weights.materialize(model, weight_seed, device)
