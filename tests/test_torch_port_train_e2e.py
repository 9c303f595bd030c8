"""End to end on the CPU: synthetic dataset -> the port's train CLI ->
checkpoints, logs, resume and the post-train eval CSVs (modelled on
tests/test_train_e2e.py), for `single` (UNet base 8) and `TransUnet` (the
small config swapped into the registry, as test_torch_port_eval.py does),
for the rest of the UNet family (`multi_task_reg` in its three combine
modes, `multi_task`, `regression`, `attention`, binary `single` under
HausdorffDTLoss) and of the TransUnet family (`regression_t`,
`multi_task_regTU`, `pretrained_npz` before a resume, `multitask_em` and
`random_crop` refused); and a JAX msgpack checkpoint converted into the
port."""

import copy
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
from unet_torch_tpu_torch.ckpt import (
    load_weights,
    save_weights,
    state_dict_from_jax_payload,
)
from unet_torch_tpu_torch.cli import train_cli
from unet_torch_tpu_torch.models.transunet.configs import CONFIGS
from unet_torch_tpu_torch.models.transunet.npz import (
    load_npz_into_model,
    synthetic_npz_weights,
)
from unet_torch_tpu_torch.models.transunet.vit import (
    VisionTransformer,
    VisionTransformerMultitask,
    build_transunet,
)
from unet_torch_tpu_torch.models.unet import (
    UNet,
    UNetAttention,
    UNetMultitask,
)

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


def test_train_cli_names_what_is_not_ported(dataset_root, tmp_path,
                                            small_transunet):
    """`random_crop` is not carried over: the JAX package's own path fails
    on its three-array batches, and the error says so."""
    raw = _cfg(dataset_root, tmp_path / "run", "TransUnet", epochs=1,
               test=False)
    raw["dataset_config"]["random_crop"] = True
    with pytest.raises(NotImplementedError,
                       match="random_crop.*DataRandomCrop"):
        train_cli.run_training(Config.from_dict(raw), device="cpu")


def test_train_cli_rejects_multitask_em(dataset_root, tmp_path,
                                        small_transunet):
    """`multitask_em` builds (build_transunet) but has no dataset or loop:
    the train CLI raises as the JAX one does."""
    raw = _cfg(dataset_root, tmp_path / "run", "multitask_em", epochs=1,
               test=False)
    with pytest.raises(ValueError, match='Invalid model_type "multitask_em"'):
        train_cli.run_training(Config.from_dict(raw), device="cpu")


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("model_type,num_class,loss,cls,csv", [
    ("regression_t", 2, "mseMC", VisionTransformer, "resultsDataMean.csv"),
    ("multi_task_regTU", 1, "multi_task_loss", VisionTransformerMultitask,
     "resultsDataMean.csv"),
])
def test_train_cli_e2e_transunet_family(dataset_root, tmp_path,
                                        small_transunet, model_type,
                                        num_class, loss, cls, csv):
    """One epoch of the rest of the TransUnet family: `regression_t` on
    DataReg with ReLU on its logits and the post-train test_single_reg;
    `multi_task_regTU` on DataRegMT in the uncertainty loop (log_vars in its
    checkpoints) and the post-train test_multiple_reg."""
    save_dir = tmp_path / "run"
    raw = _family_cfg(dataset_root, save_dir, model_type, num_class, loss,
                      epochs=1)
    trainers, results = train_cli.run_training(Config.from_dict(raw),
                                               device="cpu")
    seed_dir = save_dir / "run_seed7"
    tr = trainers[7]
    assert type(tr.model) is cls
    assert tr.relu_output == (model_type == "regression_t")
    assert len(tr.train_loss_list) == len(tr.val_loss_list) == 1
    assert np.isfinite(tr.train_loss_list + tr.val_loss_list).all()
    best = torch.load(seed_dir / "models" / "best.pt", weights_only=True)
    assert ("log_vars" in best) == (model_type == "multi_task_regTU")
    fresh = load_weights(str(seed_dir / "models" / "best.pt"),
                         build_transunet(model_type, img_size=64,
                                         num_classes=num_class))
    for key, value in tr.model.state_dict().items():
        assert torch.equal(value.cpu(), fresh.state_dict()[key]), key
    assert (seed_dir / csv).exists() and results[7]
    assert (save_dir / "results.csv").exists()


@pytest.mark.usefixtures("few_threads")
def test_train_cli_loads_pretrained_npz_before_resume(dataset_root, tmp_path,
                                                      small_transunet,
                                                      monkeypatch):
    """`model_config.pretrained_npz`: a checkpoint of Google's layout goes
    into the fresh TransUnet (its transformer only), then a resume
    checkpoint is loaded over it, so the resumed run starts from the
    checkpoint's weights, every one of them."""
    npz = tmp_path / "vit.npz"
    template = build_transunet("TransUnet", img_size=64, num_classes=3)
    np.savez(npz, **synthetic_npz_weights(template, 9, 50))
    expected = copy.deepcopy(template)
    load_npz_into_model(expected, np.load(npz))
    resume = tmp_path / "resume.pt"
    save_weights(str(resume), build_transunet(
        "TransUnet", img_size=64, num_classes=3,
        generator=torch.Generator().manual_seed(123)))

    events = []
    original_npz, original_load = (train_cli.load_npz_into_model,
                                   train_cli.load_weights)

    def npz_recording(model, weights):
        original_npz(model, weights)
        events.append("npz")
        for name, value in expected.state_dict().items():
            if name.startswith("transformer."):
                assert torch.equal(model.state_dict()[name], value), name
        return model

    def resume_recording(path, model):
        original_load(path, model)
        events.append("resume")
        saved = torch.load(path, weights_only=True)
        for name, value in model.state_dict().items():
            assert torch.equal(value, saved[name]), name
        return model

    monkeypatch.setattr(train_cli, "load_npz_into_model", npz_recording)
    monkeypatch.setattr(train_cli, "load_weights", resume_recording)
    raw = _cfg(dataset_root, tmp_path / "run", "TransUnet", epochs=1,
               test=False)
    raw["model_config"]["pretrained_npz"] = str(npz)
    raw["resume"] = {"flag": True, "path": str(resume), "epoch": 1}
    trainers, _ = train_cli.run_training(Config.from_dict(raw), device="cpu")
    assert events == ["npz", "resume"]
    assert len(trainers[7].train_loss_list) == 1


@pytest.mark.usefixtures("few_threads")
def test_train_cli_trains_under_the_topo_loss(dataset_root, tmp_path):
    """The case that named queue 1 item 12 until the topo slice: `TopoLoss`
    on the binary head now reads the dot maps and trains in the warm-up
    loop, through `python -m unet_torch_tpu_torch.cli.train_cli cfg.yml
    --device cpu` (one epoch: the dice_bce phase;
    tests/test_torch_port_topo_train.py runs all seven), its MRA score
    logged and the last epoch's checkpoint saved."""
    raw = _cfg(dataset_root, tmp_path / "run", epochs=1, test=False)
    raw["model_config"]["num_class"] = 1
    raw["train_config"]["loss"] = "TopoLoss"
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(raw))
    train_cli.main([str(path), "--device", "cpu"])
    seed_dir = tmp_path / "run" / "run_seed7"
    log = (seed_dir / "logs.txt").read_text()
    assert "Val score on epoch 1:" in log
    assert (seed_dir / "models" / "last_epoch.pt").exists()


def _family_cfg(root, save_dir, model_type, num_class, loss, accuracy=None,
                epochs=2, **train):
    raw = _cfg(root, save_dir, epochs=epochs)
    raw["model_config"].update(model_type=model_type, num_class=num_class,
                               dropout=False)
    raw["train_config"].update(loss=loss, accuracy=accuracy or loss,
                               optimizer="Adam", precision="f32", **train)
    return raw


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("model_type,num_class,loss,fresh,csv", [
    ("single", 1, "HausdorffDTLoss", lambda: UNet(3, 1, base=8),
     "resultsData.csv"),
    ("attention", 3, "dice_bce_mc", lambda: UNetAttention(3, 3, base=8),
     "resultsData.csv"),
    ("regression", 2, "mseMC", lambda: UNet(3, 2, base=8),
     "resultsDataMean.csv"),
])
def test_train_cli_e2e_single_head_family(dataset_root, tmp_path, model_type,
                                          num_class, loss, fresh, csv):
    """The other single-head runs: the binary UNet under the Hausdorff-DT
    loss (post-train test_single), the attention UNet (test_single_mc) and
    the regression UNet on DataReg with ReLU on its logits
    (test_single_reg)."""
    save_dir = tmp_path / "run"
    raw = _family_cfg(dataset_root, save_dir, model_type, num_class, loss,
                      accuracy="dice_bce" if num_class == 1 else None)
    trainers, results = train_cli.run_training(Config.from_dict(raw),
                                               device="cpu")
    seed_dir = save_dir / "run_seed7"
    tr = trainers[7]
    assert tr.relu_output == (model_type == "regression")
    assert len(tr.train_loss_list) == 2 and len(tr.val_loss_list) == 2
    assert np.isfinite(tr.train_loss_list + tr.val_loss_list).all()
    load_weights(str(seed_dir / "models" / "best.pt"), fresh())
    assert (seed_dir / csv).exists() and results[7]
    assert (save_dir / "results.csv").exists()


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("loss,combine", [("multi_task_loss", "uncertainty"),
                                          ("multi_task_loss_ratio", "ratio"),
                                          ("mse", "sum")])
def test_train_cli_e2e_multi_task_reg(dataset_root, tmp_path, loss, combine):
    """configs/multitask_reg.yml's model type on DataRegMT: the two-head
    loop in each combine mode, the per-head loss lists and curves, the
    post-train test_multiple_reg. `multi_task_loss` learns log_vars, logs the
    sigmas, trains with a fresh Adam at 5e-4 and keeps log_vars in its
    checkpoints; the ratio loop validates from epoch 6 only."""
    save_dir = tmp_path / "run"
    epochs = 6 if combine == "ratio" else 2
    raw = _family_cfg(dataset_root, save_dir, "multi_task_reg", 1, loss,
                      epochs=epochs, adaptive_lr=combine != "ratio")
    trainers, results = train_cli.run_training(Config.from_dict(raw),
                                               device="cpu")
    seed_dir = save_dir / "run_seed7"
    tr = trainers[7]
    n_val = epochs - 5 if combine == "ratio" else epochs
    assert len(tr.train_loss_list) == len(tr.train_loss_list_1) == epochs
    assert len(tr.val_loss_list) == len(tr.val_loss_list_2) == n_val
    assert np.isfinite(tr.train_loss_list + tr.val_loss_list
                       + tr.train_loss_list_1 + tr.train_loss_list_2).all()
    log = (seed_dir / "logs.txt").read_text()
    assert ("sigmas: [" in log) == (combine == "uncertainty")
    assert "saving best model" in log
    best = torch.load(seed_dir / "models" / "best.pt", weights_only=True)
    assert ("log_vars" in best) == (combine == "uncertainty")
    if combine == "uncertainty":
        assert tr.base_lr == 5e-4
        assert best["log_vars"].shape == (2,) and best["log_vars"].any()
    fresh = load_weights(str(seed_dir / "models" / "best.pt"),
                         UNetMultitask(3, 1, base=8))
    for key, value in tr.model.state_dict().items():
        assert torch.equal(value.cpu(), fresh.state_dict()[key]), key
    for png in ("total.png", "bce.png", "mse.png"):
        assert (seed_dir / png).exists(), png
    assert (seed_dir / "resultsDataMean.csv").exists() and results[7]


@pytest.mark.usefixtures("few_threads")
def test_train_cli_e2e_multi_task(dataset_root, tmp_path):
    """`multi_task` on DataRegBinary (mask, density map): the sum loop; no
    post-train test, as in the JAX CLI."""
    raw = _family_cfg(dataset_root, tmp_path / "run", "multi_task", 1, "mse",
                      epochs=1)
    trainers, results = train_cli.run_training(Config.from_dict(raw),
                                               device="cpu")
    assert results == {7: {}}
    assert len(trainers[7].train_loss_list_2) == 1


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
