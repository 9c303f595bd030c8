"""The port's train CLI refuses, with the reason and before it writes
anything, the parallel launches that one process without a launcher cannot
honour: `distributed: true` with no launcher environment, a `mesh` whose
data x model is not the world size (1 here), WORLD_SIZE > 1 without RANK and
MASTER_ADDR, and NCCL asked for with two ranks on one host's single card (or
none). A mesh of one device trains as before. The launches themselves are
tests/test_torch_port_parallel.py's."""

import os

import pytest
import torch

from unet_torch_tpu_torch.cli import train_cli
from unet_torch_tpu_torch.cli.config import Config
from unet_torch_tpu_torch.data.synthetic import write_synthetic_dataset

from test_torch_port_train_e2e import _cfg


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    for split, seed in (("train", 1), ("val", 2)):
        write_synthetic_dataset(str(root / split), n_images=2, size=64,
                                n_classes=3, seed=seed)
    return root


def _raw(root, save_dir, **train):
    raw = _cfg(root, save_dir, "single", epochs=1, test=False)
    raw["train_config"].update(train)
    return raw


_LAUNCHER = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
             "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
             "MASTER_PORT": "29511"}


@pytest.mark.parametrize("train,env,backend,error,match", [
    ({"distributed": True}, None, None, RuntimeError,
     r"distributed: true needs a launcher: RANK, WORLD_SIZE, MASTER_ADDR, "
     r"MASTER_PORT not set; launch the ranks with torchrun"),
    ({"mesh": {"data": 2}}, None, None, ValueError,
     r"mesh data 2 x model 1 is not the world size 1"),
    ({"mesh": {"model": 2}}, None, None, ValueError,
     r"mesh data 0 x model 2 is not the world size 1"),
    ({}, {"WORLD_SIZE": "2"}, None, RuntimeError,
     r"WORLD_SIZE=2 needs a launcher: RANK, MASTER_ADDR, MASTER_PORT not "
     r"set"),
    ({}, _LAUNCHER, "nccl", ValueError,
     r"backend 'nccl' needs a card of its own for every rank: 2 ranks on "
     r"this host and 1 card\(s\)"),
], ids=["distributed", "mesh_data_2", "mesh_model_2", "world_size_2",
        "nccl_two_ranks_one_card"])
def test_train_cli_refuses_parallel_training(dataset_root, tmp_path,
                                             monkeypatch, train, env,
                                             backend, error, match):
    save_dir = tmp_path / "run"
    save_dir.mkdir()
    for k in _LAUNCHER:
        monkeypatch.delenv(k, raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    if backend == "nccl":
        # a host of one card: the two ranks would share it
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = Config.from_dict(_raw(dataset_root, save_dir, **train))
    with pytest.raises(error, match=match):
        train_cli.run_training(cfg, device="cpu", backend=backend)
    assert os.listdir(save_dir) == []
    assert not torch.distributed.is_initialized()


def test_train_cli_trains_on_a_mesh_of_one_device(dataset_root, tmp_path,
                                                  monkeypatch):
    """`mesh: {data: 1, model: 1}` and WORLD_SIZE=1 ask for one device: the
    run trains and keeps its checkpoints."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    raw = _raw(dataset_root, tmp_path / "run",
               mesh={"data": 1, "model": 1})
    cfg = Config.from_dict(raw)
    assert cfg.train.mesh == {"data": 1, "model": 1}
    train_cli.run_training(cfg, device="cpu")
    models = tmp_path / "run" / "run_seed7" / "models"
    assert (models / "last_epoch.pt").exists()
