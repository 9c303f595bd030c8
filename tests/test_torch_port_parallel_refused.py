"""The port's train CLI refuses what would spread training over several
processes or devices (`distributed: true`, a `mesh` of more than one data or
model shard, a launch with WORLD_SIZE > 1), with the reason and before it
writes anything; a mesh of one device trains as before."""

import os

import pytest

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


@pytest.mark.parametrize("train,env,match", [
    ({"distributed": True}, None,
     r"option 'distributed' is not ported: .*one device.*item 13.*Dice sums"
     r".*BatchNorm"),
    ({"mesh": {"data": 2}}, None,
     r"option 'mesh' is not ported: .*data > 1.*item 13.*BatchNorm"),
    ({"mesh": {"model": 2}}, None,
     r"option 'mesh' is not ported: .*model > 1.*tensor parallelism"),
    ({}, "2", r"WORLD_SIZE=2 processes is not ported: .*item 13.*Dice sums"),
], ids=["distributed", "mesh_data_2", "mesh_model_2", "world_size_2"])
def test_train_cli_refuses_parallel_training(dataset_root, tmp_path,
                                             monkeypatch, train, env, match):
    save_dir = tmp_path / "run"
    save_dir.mkdir()
    if env is not None:
        monkeypatch.setenv("WORLD_SIZE", env)
    cfg = Config.from_dict(_raw(dataset_root, save_dir, **train))
    with pytest.raises(NotImplementedError, match=match):
        train_cli.run_training(cfg, device="cpu")
    assert os.listdir(save_dir) == []


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
