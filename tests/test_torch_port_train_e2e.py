"""End to end on the CPU: synthetic dataset -> the port's train CLI ->
checkpoints, logs, resume and the post-train eval CSVs (modelled on
tests/test_train_e2e.py), for `single` (UNet base 8) and `TransUnet` (the
small config swapped into the registry, as test_torch_port_eval.py does);
and a JAX msgpack checkpoint converted into the port."""

import functools
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from unet_torch_tpu import ckpt as jax_ckpt
from unet_torch_tpu.cli.config import Config
from unet_torch_tpu.data.synthetic import write_synthetic_dataset
from unet_torch_tpu.models.transunet import CONFIGS as JAX_CONFIGS
from unet_torch_tpu.models.transunet import VisionTransformer as JaxViT
from unet_torch_tpu.models.unet import UNet as JaxUNet
from unet_torch_tpu_torch.ckpt import load_weights, state_dict_from_jax_payload
from unet_torch_tpu_torch.cli import train_cli
from unet_torch_tpu_torch.models.transunet.configs import CONFIGS
from unet_torch_tpu_torch.models.transunet.vit import (
    VisionTransformer,
    build_transunet,
)
from unet_torch_tpu_torch.models.unet import UNet

from test_torch_port_transunet import small_config


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    for split, seed in (("train", 1), ("val", 2), ("test", 3)):
        write_synthetic_dataset(str(root / split), n_images=3, size=64,
                                n_classes=3, seed=seed)
    return root


@pytest.fixture
def small_transunet(monkeypatch):
    monkeypatch.setitem(CONFIGS, "R50-ViT-B_16", small_config(CONFIGS))


def _cfg(root, save_dir, model_type="single", epochs=2, test=True):
    return {
        "model_config": {
            "initial_filter_size": [8], "input_size": [64, 64],
            "channel": 3, "num_class": 3, "model_type": model_type,
            "dropout": model_type == "single", "drop_out_rate": [0.2],
            "fold": False,
        },
        "train_config": {
            "loss": "dice_bce_mc", "accuracy": "dice_bce_mc",
            "optimizer": "Adam" if model_type == "single" else "SGD",
            "lr_rate": [0.001], "adaptive_lr": True,
            "weight_decay": [0.0001], "batch_size": [2], "epochs": epochs,
            "early_stop": 25, "num_workers": 0, "seed": [7],
            "precision": "bf16",
        },
        "dataset_config": {
            "train_path": [str(root / "train")],
            "val_path": [str(root / "val")],
            "test_path": [str(root / "test")] if test else [],
            "augmentation": True, "save_dir": str(save_dir),
        },
        "resume": {"flag": False, "path": "", "epoch": 1},
    }


def _fresh(model_type):
    if model_type == "single":
        return UNet(3, 3, base=8)
    return build_transunet("TransUnet", img_size=64, num_classes=3)


@pytest.mark.parametrize("model_type", ["single", "TransUnet"])
def test_train_cli_e2e(dataset_root, tmp_path, small_transunet, model_type):
    save_dir = tmp_path / "run"
    trainers, results = train_cli.run_training(
        Config.from_dict(_cfg(dataset_root, save_dir, model_type)),
        device="cpu")
    seed_dir = save_dir / "run_seed7"
    assert (save_dir / "config.json").exists()
    log = (seed_dir / "logs.txt").read_text()
    assert "Epoch 2/2" in log and "saving best model" in log
    assert (seed_dir / "total.png").exists()
    # the epoch checkpoints are pruned after the post-train test
    assert sorted(os.listdir(seed_dir / "models")) == ["best.pt",
                                                       "last_epoch.pt"]
    for name in ("best.pt", "last_epoch.pt"):
        load_weights(str(seed_dir / "models" / name), _fresh(model_type))
    for csv in ("resultsData.csv", "resultsMatching.csv",
                "resultsGridCount.csv", "results.csv"):
        assert (seed_dir / csv).exists(), csv
    assert (save_dir / "results.csv").exists()
    assert 7 in results and "Cell MAE" in results[7]
    tr = trainers[7]
    assert len(tr.train_loss_list) == 2 and len(tr.val_loss_list) == 2
    assert np.isfinite(tr.train_loss_list + tr.val_loss_list).all()
    # the best weights are restored at the end
    best = torch.load(seed_dir / "models" / "best.pt", weights_only=True)
    for key, value in tr.model.state_dict().items():
        assert torch.equal(value.cpu(), best[key]), key


def test_train_cli_main_and_resume(dataset_root, tmp_path):
    """`python -m ...train_cli cfg.yml --device cpu`, then a resume from its
    last_epoch.pt at epoch 2 of 3: two epochs run, from those weights."""
    raw = _cfg(dataset_root, tmp_path / "run1", epochs=1, test=False)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(raw))
    train_cli.main([str(path), "--device", "cpu"])
    last = tmp_path / "run1" / "run1_seed7" / "models" / "last_epoch.pt"
    assert last.exists()
    assert (tmp_path / "run1" / "run1_seed7" / "total.png").exists()

    raw2 = _cfg(dataset_root, tmp_path / "run2", epochs=3, test=False)
    raw2["resume"] = {"flag": True, "path": str(last), "epoch": 2}
    loaded = []
    original = train_cli.load_weights

    def recording(path, model):
        loaded.append(path)
        return original(path, model)

    train_cli.load_weights = recording
    try:
        trainers, results = train_cli.run_training(Config.from_dict(raw2),
                                                   device="cpu")
    finally:
        train_cli.load_weights = original
    assert loaded == [str(last)] and results == {}
    tr = trainers[7]
    assert len(tr.train_loss_list) == 2
    assert "Epoch 2/3" in (tmp_path / "run2" / "run2_seed7" /
                           "logs.txt").read_text()


def test_train_cli_without_matplotlib(dataset_root, tmp_path, monkeypatch):
    """Where matplotlib cannot be imported (the card's machine has none),
    a run whose config names a test set trains and keeps its checkpoints,
    draws no curves and skips the post-train test with a warning."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    raw = _cfg(dataset_root, tmp_path / "run", epochs=1)
    with pytest.warns(UserWarning, match="post-train test is skipped"):
        trainers, results = train_cli.run_training(Config.from_dict(raw),
                                                   device="cpu")
    seed_dir = tmp_path / "run" / "run_seed7"
    assert results == {} and len(trainers[7].train_loss_list) == 1
    assert sorted(os.listdir(seed_dir / "models")) == ["best.pt",
                                                       "last_epoch.pt"]
    assert not (seed_dir / "total.png").exists()
    assert not (seed_dir / "resultsData.csv").exists()
    assert not (tmp_path / "run" / "results.csv").exists()


@pytest.mark.parametrize("change,match", [
    ({"model_type": "multi_task"}, "queue 1 item 8"),
    ({"model_type": "CLTR"}, "queue 1 item 11"),
    ({"model_type": "regression"}, "queue 1 item 8"),
    ({"model_type": "TransUnet", "random_crop": True}, "queue 1 item 10"),
    ({"model_type": "TransUnet", "pretrained_npz": "vit.npz"},
     "queue 1 item 10"),
    ({"loss": "TopoLoss"}, "queue 1 item 12"),
])
def test_train_cli_names_what_is_not_ported(dataset_root, tmp_path,
                                            small_transunet, change, match):
    raw = _cfg(dataset_root, tmp_path / "run", epochs=1, test=False)
    for key, value in change.items():
        section = {"random_crop": "dataset_config",
                   "loss": "train_config"}.get(key, "model_config")
        raw[section][key] = value
    with pytest.raises(NotImplementedError, match=match):
        train_cli.run_training(Config.from_dict(raw), device="cpu")


def test_train_cli_needs_a_gpu_for_cuda(dataset_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU case cannot be shown here")
    raw = _cfg(dataset_root, tmp_path / "run", epochs=1, test=False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.run_training(Config.from_dict(raw))


@pytest.mark.parametrize("model_type", ["single", "TransUnet"])
def test_jax_checkpoint_converts(tmp_path, model_type):
    """A JAX checkpoint (flax msgpack, as the JAX trainer writes best.pt),
    read with flax, converts through state_dict_from_jax_payload into a
    state_dict that loads strictly and serves the JAX model's logits."""
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    if model_type == "single":
        model = JaxUNet(3, 3, base=8)
        port = UNet(3, 3, base=8)
    else:
        model = JaxViT(small_config(JAX_CONFIGS), img_size=64, num_classes=3)
        port = VisionTransformer(small_config(CONFIGS), 64, 3)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(1), jnp.asarray(x))
    path = str(tmp_path / "best.pt")
    jax_ckpt.save_weights(path, variables["params"], variables["batch_stats"])
    payload = jax_ckpt.load_weights(path)
    port.load_state_dict(state_dict_from_jax_payload(payload), strict=True)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    port.eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    # the bound of the eval parity tests (JAX against torch, f32)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=1e-3)
