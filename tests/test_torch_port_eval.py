"""The port's eval slices end to end on the CPU, against the JAX package's:
the same seeded weights and the same synthetic test set through both eval
CLIs (run_eval -> test_single_mc -> batched predict -> class_argmax), for the
UNet and for TransUnet; and the modes `single`, `single_crop`, `reg` and
`mt_reg` (binary UNet, two-channel regression UNet, UNetMultitask)."""

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
from unet_torch_tpu.eval import reports as jax_reports
from unet_torch_tpu.models.transunet import CONFIGS as JAX_CONFIGS
from unet_torch_tpu.models.transunet import build_transunet as jax_transunet
from unet_torch_tpu.models.unet import UNet as JaxUNet
from unet_torch_tpu.models.unet import UNetMultitask as JaxUNetMultitask
from unet_torch_tpu_torch.ckpt.bridge import (
    state_dict_from_flax,
    transunet_state_dict_from_flax,
)
from unet_torch_tpu_torch.cli.test_cli import _auto_mode
from unet_torch_tpu_torch.cli.test_cli import run_eval as port_run_eval
from unet_torch_tpu_torch.core.device import resolve_device
from unet_torch_tpu_torch.eval import results as port_results
from unet_torch_tpu_torch.eval.metrics import class_argmax
from unet_torch_tpu_torch.models.transunet.configs import CONFIGS

from test_torch_port_transunet import small_config


@pytest.fixture
def few_threads():
    """Two intra-op threads for the duration of a test: the suite runs in
    several worker processes at once, and the small CPU models of these
    tests otherwise fight over the cores. Tests that do not ask for it keep
    the process's default."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(root, save_dir, model_type="single", num_class=3):
    return Config.from_dict({
        "model_config": {
            "initial_filter_size": [8], "input_size": [64, 64], "channel": 3,
            "num_class": num_class, "model_type": model_type,
            "dropout": False,
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
                       state_dict, mode="auto", accumulator="Results2Class",
                       method="compare_images", pred_args=(2,), rtol=1e-9,
                       **eval_kw):
    """Both eval CLIs on the same weights: what they hand the report
    accumulator (argument `pred_args` of its `method`) agrees, and so do the
    result dicts. Each package's accumulator class is its own."""
    jax_path = str(tmp_path / "jax_best.pt")
    jax_ckpt.save_weights(jax_path, params, batch_stats)
    port_path = str(tmp_path / "port_best.pt")
    torch.save(state_dict, port_path)

    preds = {"jax": [], "port": []}
    for side, module in (("jax", jax_reports), ("port", port_results)):
        cls = getattr(module, accumulator)
        original = getattr(cls, method)

        def recording(self, *args, _side=side, _original=original):
            # args[0] follows self
            preds[_side].append([np.array(args[i - 1]) for i in pred_args])
            return _original(self, *args)

        monkeypatch.setattr(cls, method, recording)
    ref = jax_run_eval(cfg, jax_path, mode=mode,
                       out_dir=str(tmp_path / "eval_jax"), **eval_kw)
    torch.backends.cudnn.allow_tf32 = False
    with pytest.warns(UserWarning, match="fold"):  # the config's TPU default
        ours = port_run_eval(cfg, port_path, mode=mode,
                             out_dir=str(tmp_path / "eval_port"),
                             device="cpu", **eval_kw)

    assert len(preds["port"]) == len(preds["jax"]) == 10
    integer = preds["jax"][0][0].dtype == np.uint8
    for a_list, b_list in zip(preds["port"], preds["jax"]):
        for a, b in zip(a_list, b_list):
            assert a.shape == b.shape == (64, 64) and a.dtype == b.dtype
            if integer:
                # f32 logits agree to ~1e-6 (test_torch_port_unet.py,
                # test_torch_port_transunet.py); only an argmax or threshold
                # near-tie can flip a pixel
                assert np.mean(a == b) >= 0.999
            else:
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-4)
    # not a constant map
    assert len(np.unique(np.stack([p[0] for p in preds["jax"]]))) > 1
    assert os.listdir(tmp_path / "eval_port")
    assert set(ours) == set(ref) and ref
    for key in ref:
        # every value is a count, ratio or score computed from the maps;
        # with maps that agree the values agree to float round-off
        np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                   np.asarray(ref[key], np.float64),
                                   rtol=rtol, atol=1e-12, equal_nan=True,
                                   err_msg=key)


def _jax_weights(model, seed):
    rng = np.random.RandomState(seed)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = model.init(jax.random.key(seed), x, train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return params, _seeded_stats(rng, variables["batch_stats"])


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("mode", ["single", "single_crop"])
def test_binary_eval_cli_matches_jax(tmp_path, monkeypatch, mode):
    """The sigmoid-threshold suites on a one-logit UNet: whole images, and
    32x32 tiles (four a image: one padded chunk of 16)."""
    cfg = _config(_dataset(tmp_path / "d"), tmp_path / "run", num_class=1)
    params, batch_stats = _jax_weights(JaxUNet(3, 1, base=8), 11)
    # a head bias of 0 keeps the threshold inside the logits' range
    _compare_eval_clis(tmp_path, monkeypatch, cfg, params, batch_stats,
                       state_dict_from_flax(params, batch_stats), mode=mode,
                       accumulator="ResultsCC",
                       **({"crop_size": 32} if mode == "single_crop" else {}))
    assert os.path.exists(tmp_path / "eval_port" / "img0.png")


@pytest.mark.usefixtures("few_threads")
def test_reg_eval_cli_matches_jax(tmp_path, monkeypatch):
    """`reg`: a two-channel regression UNet, channels [other, immune]; the
    density maps agree to the logits' 1e-6, the counts and scores to 1e-4."""
    cfg = _config(_dataset(tmp_path / "d"), tmp_path / "run", "regression",
                  num_class=2)
    params, batch_stats = _jax_weights(JaxUNet(3, 2, base=8), 12)
    _compare_eval_clis(tmp_path, monkeypatch, cfg, params, batch_stats,
                       state_dict_from_flax(params, batch_stats), mode="auto",
                       accumulator="TwoChannelRegResults", method="add",
                       pred_args=(1, 2), rtol=1e-4)


@pytest.mark.usefixtures("few_threads")
def test_mt_reg_eval_cli_matches_jax(tmp_path, monkeypatch):
    """`mt_reg`: the two heads (immune, other) of UNetMultitask."""
    cfg = _config(_dataset(tmp_path / "d"), tmp_path / "run",
                  "multi_task_reg", num_class=1)
    params, batch_stats = _jax_weights(JaxUNetMultitask(3, 1, base=8), 13)
    _compare_eval_clis(tmp_path, monkeypatch, cfg, params, batch_stats,
                       state_dict_from_flax(params, batch_stats), mode="auto",
                       accumulator="TwoChannelRegResults", method="add",
                       pred_args=(1, 2), rtol=1e-4)


@pytest.mark.parametrize("model_type,mode", [
    ("single", "single_mc"), ("attention", "single_mc"),
    ("TransUnet", "single_mc"), ("multi_task_reg", "mt_reg"),
    ("multi_task_regTU", "mt_reg"), ("regression", "reg"),
    ("regression_t", "reg")])
def test_auto_mode_is_the_jax_clis(model_type, mode):
    from unet_torch_tpu.cli.test_cli import _auto_mode as jax_auto_mode

    assert _auto_mode(model_type) == jax_auto_mode(model_type) == mode


def test_eval_cli_rejects_unknown_modes_and_types(tmp_path):
    cfg = _config(tmp_path, tmp_path / "run")
    with pytest.raises(ValueError, match="Unknown mode"):
        port_run_eval(cfg, "none.pt", mode="single_mcc", device="cpu")
    with pytest.raises(ValueError, match="No eval mode"):
        _auto_mode("multi_task")


def test_eval_cli_matches_jax(tmp_path, monkeypatch):
    cfg = _config(_dataset(tmp_path / "d"), tmp_path / "run")
    params, batch_stats = _jax_weights(JaxUNet(3, 3, base=8), 7)
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
