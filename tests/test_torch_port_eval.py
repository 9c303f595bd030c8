"""The port's eval slices end to end on the CPU, against the JAX package's:
the same seeded weights and the same synthetic test set through both eval
CLIs (run_eval -> test_single_mc -> batched predict -> class_argmax), for the
UNet and for TransUnet."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_torch_tpu import ckpt as jax_ckpt
from unet_torch_tpu.cli.config import Config
from unet_torch_tpu.cli.test_cli import run_eval as jax_run_eval
from unet_torch_tpu.data.synthetic import write_synthetic_dataset
from unet_torch_tpu.eval.metrics import class_argmax as jax_class_argmax
from unet_torch_tpu.eval.reports import Results2Class
from unet_torch_tpu.models.transunet import CONFIGS as JAX_CONFIGS
from unet_torch_tpu.models.transunet import build_transunet as jax_transunet
from unet_torch_tpu.models.unet import UNet as JaxUNet
from unet_torch_tpu_torch.ckpt.bridge import (
    state_dict_from_flax,
    transunet_state_dict_from_flax,
)
from unet_torch_tpu_torch.cli.test_cli import run_eval as port_run_eval
from unet_torch_tpu_torch.core.device import resolve_device
from unet_torch_tpu_torch.eval.metrics import class_argmax
from unet_torch_tpu_torch.models.transunet.configs import CONFIGS

from test_torch_port_transunet import small_config


def _config(root, save_dir, model_type="single"):
    return Config.from_dict({
        "model_config": {
            "initial_filter_size": [8], "input_size": [64, 64], "channel": 3,
            "num_class": 3, "model_type": model_type, "dropout": False,
        },
        "train_config": {"loss": "dice_bce_mc", "batch_size": [2],
                         "seed": [9]},
        "dataset_config": {
            "train_path": [str(root / "train")],
            "val_path": [str(root / "val")],
            "test_path": [str(root / "test")],
            "augmentation": False, "save_dir": str(save_dir),
        },
    })


def _dataset(root):
    for split, n in (("train", 2), ("val", 2), ("test", 10)):
        # 10 test images: a full chunk of 8 and a padded one of 2
        write_synthetic_dataset(str(root / split), n_images=n, size=64,
                                n_classes=3, seed=2)
    return root


def _seeded_stats(rng, batch_stats):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: ((rng.rand(*a.shape) + 0.5) if p[-1].key == "var"
                      else rng.randn(*a.shape) * 0.1).astype(np.float32),
        batch_stats)


def _compare_eval_clis(tmp_path, monkeypatch, cfg, params, batch_stats,
                       state_dict):
    """Both eval CLIs on the same weights: the class maps agree and so do
    the result dicts."""
    jax_path = str(tmp_path / "jax_best.pt")
    jax_ckpt.save_weights(jax_path, params, batch_stats)
    port_path = str(tmp_path / "port_best.pt")
    torch.save(state_dict, port_path)

    preds = {"jax": [], "port": []}
    compare = Results2Class.compare_images
    side = []

    def recording(self, img_org, gt_img, pred_img, gt_dot):
        preds[side[-1]].append(np.array(pred_img))
        return compare(self, img_org, gt_img, pred_img, gt_dot)

    monkeypatch.setattr(Results2Class, "compare_images", recording)
    side.append("jax")
    ref = jax_run_eval(cfg, jax_path, out_dir=str(tmp_path / "eval_jax"))
    side.append("port")
    torch.backends.cudnn.allow_tf32 = False
    with pytest.warns(UserWarning, match="fold"):  # the config's TPU default
        ours = port_run_eval(cfg, port_path,
                             out_dir=str(tmp_path / "eval_port"),
                             device="cpu")

    assert len(preds["port"]) == len(preds["jax"]) == 10
    assert len(np.unique(np.stack(preds["jax"]))) > 1  # not a constant map
    for a, b in zip(preds["port"], preds["jax"]):
        assert a.shape == b.shape == (64, 64) and a.dtype == np.uint8
        # f32 logits agree to ~1e-6 (test_torch_port_unet.py,
        # test_torch_port_transunet.py); only an argmax near-tie can flip a
        # pixel
        assert np.mean(a == b) >= 0.999
    assert os.path.exists(tmp_path / "eval_port" / "resultsData.csv")
    assert set(ours) == set(ref)
    for key in ref:
        # every value is a count, ratio or score computed from the class
        # maps; with maps that agree the values agree to float round-off
        np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                   np.asarray(ref[key], np.float64),
                                   rtol=1e-9, atol=1e-12, equal_nan=True,
                                   err_msg=key)


def test_eval_cli_matches_jax(tmp_path, monkeypatch):
    cfg = _config(_dataset(tmp_path / "d"), tmp_path / "run")
    rng = np.random.RandomState(7)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = JaxUNet(3, 3, base=8).init(jax.random.key(7), x, train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    batch_stats = _seeded_stats(rng, variables["batch_stats"])
    _compare_eval_clis(tmp_path, monkeypatch, cfg, params, batch_stats,
                       state_dict_from_flax(params, batch_stats))


def test_transunet_eval_cli_matches_jax(tmp_path, monkeypatch):
    """configs/transunet.yml's model_type at 64x64. Both CLIs build
    R50-ViT-B_16, which is swapped for the small config in both registries
    so that no full-width model is built on the CPU."""
    monkeypatch.setitem(JAX_CONFIGS, "R50-ViT-B_16",
                        small_config(JAX_CONFIGS))
    monkeypatch.setitem(CONFIGS, "R50-ViT-B_16", small_config(CONFIGS))
    cfg = _config(_dataset(tmp_path / "d"), tmp_path / "run", "TransUnet")
    rng = np.random.RandomState(8)
    model = jax_transunet("TransUnet", img_size=64, n_channels=3,
                          num_classes=3)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = model.init(jax.random.key(8), x, train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    batch_stats = _seeded_stats(rng, variables["batch_stats"])
    _compare_eval_clis(tmp_path, monkeypatch, cfg, params, batch_stats,
                       transunet_state_dict_from_flax(params, batch_stats))


def test_class_argmax_matches_jax_on_ties():
    rng = np.random.RandomState(0)
    logits = rng.randint(0, 3, size=(2, 8, 8, 4)).astype(np.float32)
    ref = np.asarray(jax_class_argmax(jnp.asarray(logits)))
    ours = class_argmax(torch.from_numpy(logits))
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_resolve_device_never_falls_back_to_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU case cannot be shown here")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
