"""The port's configuration as its train CLI builds it: the Config from the
configuration file's `yaml` section (the shipped YAML, its dataset paths
pointed at the run's tiles), the datasets and the model from
`build_datasets_and_model`, the model built on the meta device and given
the benchmark's weights from the seed."""

from __future__ import annotations

import copy

import torch

from perfbench.core import weights


def config(cell, train_dir: str, empty_dir: str):
    from unet_torch_tpu_torch.cli.config import Config

    raw = copy.deepcopy(cell["config_spec"]["yaml"])
    raw["dataset_config"]["train_path"] = [train_dir]
    raw["dataset_config"]["val_path"] = [empty_dir]
    raw["dataset_config"]["test_path"] = []
    return Config.from_dict(raw)


def build(cfg, seed: int, weight_seed: int, device):
    """(train dataset, model on `device` with the seed's weights, compute
    dtype), as run_training builds them."""
    from unet_torch_tpu_torch import losses
    from unet_torch_tpu_torch.cli.train_cli import build_datasets_and_model
    from unet_torch_tpu_torch.core.precision import resolve_precision
    from unet_torch_tpu_torch.core.rng import seed_everything

    losses.set_class_number(cfg.model.num_class)
    seed_everything(seed)
    with torch.device("meta"):
        train_ds, _, model = build_datasets_and_model(cfg, seed)
    weights.materialize(model, weight_seed, device)
    return train_ds, model, resolve_precision(cfg.train.precision)
