"""The port's CLIs where matplotlib cannot be imported (the card's machine
has none): the eval CLI in every mode writes the JAX package's CSVs byte for
byte and returns its results, the train CLI runs its post-train test and
writes results.csv; and the helpers of chip_smoke.py's CLI phases (the
derived configs, the near-tie count), the train CLI's card naming."""

import functools
import importlib.util
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from unet_torch_tpu import ckpt as jax_ckpt
from unet_torch_tpu.cli.config import Config
from unet_torch_tpu.cli.test_cli import run_eval as jax_run_eval
from unet_torch_tpu.data.synthetic import write_synthetic_dataset
from unet_torch_tpu.eval import reports as jax_reports
from unet_torch_tpu.models.unet import UNet as JaxUNet
from unet_torch_tpu.models.unet import UNetMultitask as JaxUNetMultitask
from unet_torch_tpu_torch.ckpt.bridge import state_dict_from_flax
from unet_torch_tpu_torch.cli import train_cli
from unet_torch_tpu_torch.cli.test_cli import run_eval as port_run_eval
from unet_torch_tpu_torch.eval import results as port_results

from test_torch_port_eval import _jax_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def few_threads():
    """Two intra-op threads for the duration of a test: the suite runs in
    several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _csvs(directory):
    return {f: open(os.path.join(directory, f)).read()
            for f in sorted(os.listdir(directory)) if f.endswith(".csv")}


def _pngs(directory):
    return [os.path.relpath(os.path.join(d, f), directory)
            for d, _, files in os.walk(directory) for f in files
            if f.endswith(".png")]


def _same_results(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key], np.float64),
                                      np.asarray(b[key], np.float64),
                                      err_msg=key)


# ---------------------------------------------------------------- eval CLI

# mode -> (model type, classes, the JAX model, the accumulator, its method,
# the positions of the predictions among the method's arguments)
_MODES = {
    "single_mc3": ("single", 3, lambda: JaxUNet(3, 3, base=8),
                   "Results2Class", "compare_images", (2,)),
    "single_mc4": ("single", 4, lambda: JaxUNet(3, 4, base=8),
                   "Results3Class", "compare_images", (2,)),
    "single": ("single", 1, lambda: JaxUNet(3, 1, base=8), "ResultsCC",
               "compare_images", (2,)),
    "single_crop": ("single", 1, lambda: JaxUNet(3, 1, base=8), "ResultsCC",
                    "compare_images", (2,)),
    "reg": ("regression", 2, lambda: JaxUNet(3, 2, base=8),
            "TwoChannelRegResults", "add", (0, 1)),
    "mt_reg": ("multi_task_reg", 1, lambda: JaxUNetMultitask(3, 1, base=8),
               "TwoChannelRegResults", "add", (0, 1)),
}


def _eval_config(root, model_type, num_class):
    return Config.from_dict({
        "model_config": {
            "initial_filter_size": [8], "input_size": [64, 64], "channel": 3,
            "num_class": num_class, "model_type": model_type,
            "dropout": False,
        },
        "train_config": {"loss": "dice_bce_mc", "batch_size": [2],
                         "seed": [9]},
        "dataset_config": {"test_path": [str(root / "test")],
                           "augmentation": False,
                           "save_dir": str(root / "run")},
    })


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("case", sorted(_MODES))
def test_eval_cli_without_matplotlib_equals_jax(tmp_path, monkeypatch,
                                                capsys, case):
    """The same checkpoint (a seeded JAX one and its conversion by the
    bridge) through the JAX package's run_eval with matplotlib and the
    port's with matplotlib blocked: the port's predictions agree with
    JAX's (the maps on 99.9% of their pixels, the densities to 1e-6), and
    given JAX's predictions its reports write the same CSV files byte for
    byte and return equal results; no PNG, and one line naming the skipped
    plots."""
    model_type, num_class, model, accumulator, method, positions = \
        _MODES[case]
    mode = case.rstrip("34")
    # 10 test images: a full chunk of 8 and a padded one of 2
    write_synthetic_dataset(str(tmp_path / "test"), n_images=10, size=64,
                            n_classes=max(num_class, 3), seed=2)
    cfg = _eval_config(tmp_path, model_type, num_class)
    params, batch_stats = _jax_weights(model(), 11)
    jax_path = str(tmp_path / "jax_best.pt")
    jax_ckpt.save_weights(jax_path, params, batch_stats)
    port_path = str(tmp_path / "port_best.pt")
    torch.save(state_dict_from_flax(params, batch_stats), port_path)
    kw = {"crop_size": 32} if mode == "single_crop" else {}

    jax_preds = []
    jax_cls = getattr(jax_reports, accumulator)
    jax_method = getattr(jax_cls, method)

    def jax_recording(self, *args):
        jax_preds.append([np.array(args[i]) for i in positions])
        return jax_method(self, *args)

    monkeypatch.setattr(jax_cls, method, jax_recording)
    ref = jax_run_eval(cfg, jax_path, mode=mode,
                       out_dir=str(tmp_path / "eval_jax"), **kw)
    assert _pngs(tmp_path / "eval_jax")

    port_cls = getattr(port_results, accumulator)
    port_method = getattr(port_cls, method)
    seen = []

    def port_handing_jax_preds(self, *args):
        """The port's predictions against JAX's, then JAX's handed on."""
        jax_side = jax_preds[len(seen)]
        for i, b in zip(positions, jax_side):
            a = np.asarray(args[i])
            assert a.shape == b.shape and a.dtype == b.dtype
            if a.dtype == np.uint8:
                assert np.mean(a == b) >= 0.999
            else:
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-4)
        seen.append(1)
        args = list(args)
        for i, b in zip(positions, jax_side):
            args[i] = b
        return port_method(self, *args)

    monkeypatch.setattr(port_cls, method, port_handing_jax_preds)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    torch.backends.cudnn.allow_tf32 = False
    with pytest.warns(UserWarning, match="fold"):  # the config's TPU default
        ours = port_run_eval(cfg, port_path, mode=mode,
                             out_dir=str(tmp_path / "eval_port"),
                             device="cpu", **kw)
    assert len(seen) == len(jax_preds) == 10
    _same_results(ref, ours)
    jax_csvs = _csvs(tmp_path / "eval_jax")
    assert jax_csvs and _csvs(tmp_path / "eval_port") == jax_csvs
    assert not _pngs(tmp_path / "eval_port")
    notes = [ln for ln in capsys.readouterr().out.splitlines()
             if "plots not drawn" in ln]
    assert len(notes) == 1 and str(tmp_path / "eval_port") in notes[0]


# ---------------------------------------------------------------- train CLI

def _train_config(root, save_dir, model_type, num_class, loss):
    return {
        "model_config": {
            "initial_filter_size": [8], "input_size": [64, 64],
            "channel": 3, "num_class": num_class, "model_type": model_type,
            "fold": False, "fused_head": False,
        },
        "train_config": {
            "loss": loss, "accuracy": loss, "optimizer": "Adam",
            "lr_rate": [0.001], "adaptive_lr": True,
            "weight_decay": [0.0001], "batch_size": [2], "epochs": 1,
            "early_stop": 25, "num_workers": 0, "seed": [7, 8],
            "precision": "bf16",
        },
        "dataset_config": {
            "train_path": [str(root / "train")],
            "val_path": [str(root / "val")],
            "test_path": [str(root / "test")],
            "dot_annotation_path": str(root / "test"),
            "augmentation": False, "save_dir": str(save_dir),
        },
    }


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_card")
    for split, seed in (("train", 1), ("val", 2), ("test", 3)):
        write_synthetic_dataset(str(root / split), n_images=2, size=64,
                                n_classes=3, seed=seed)
    return root


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("model_type,num_class,loss,csvs", [
    ("single", 3, "dice_bce_mc",
     ("resultsC.csv", "resultsGridCount.csv", "resultsMatching.csv")),
    ("single", 1, "dice_bce", ("resultsCount.csv", "resultsMatching.csv")),
    ("multi_task_reg", 1, "multi_task_loss",
     ("resultsDataMean.csv", "resultsDataFiltered.csv",
      "resultsGridCount.csv")),
], ids=["single_mc", "binary", "multi_task_reg"])
def test_run_training_writes_post_train_reports_without_matplotlib(
        train_root, tmp_path, monkeypatch, capsys, model_type, num_class,
        loss, csvs):
    """run_training with a test set and matplotlib blocked: each seed's
    post-train CSVs, the cross-seed results.csv (a row a seed, the results
    returned), the pruned checkpoints; no PNG."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    save_dir = tmp_path / "run"
    trainers, results = train_cli.run_training(
        Config.from_dict(_train_config(train_root, save_dir, model_type,
                                       num_class, loss)), device="cpu")
    assert sorted(trainers) == sorted(results) == [7, 8]
    for seed in (7, 8):
        seed_dir = save_dir / f"run_seed{seed}"
        for csv in ("resultsData.csv",) + csvs:
            assert (seed_dir / csv).exists(), csv
        assert sorted(os.listdir(seed_dir / "models")) == ["best.pt",
                                                           "last_epoch.pt"]
    table = pd.read_csv(save_dir / "results.csv", index_col=0)
    assert sorted(table.index) == [7, 8]
    assert list(table.columns) == list(results[7])
    assert not _pngs(save_dir)
    out = capsys.readouterr().out
    assert "the curves (total.png) are not drawn" in out
    assert len([ln for ln in out.splitlines() if "plots not drawn" in ln]) == 2


# ---------------------------------------------------- chip_smoke.py's helpers

@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in os.listdir(os.path.join(ROOT, "configs"))
    if p.endswith(".yml")))
def test_derive_config_changes_only_the_derived_keys(name):
    """Each shipped config, derived as the CLI phases derive it: the
    dataset paths, save_dir, epochs, the seed list and resume change, every
    other key (each model_config width among them) stays as shipped, and the
    shipped dict is left as it was."""
    cs = _chip_smoke()
    with open(os.path.join(ROOT, "configs", name)) as f:
        raw = yaml.safe_load(f)
    shipped = yaml.safe_load(yaml.safe_dump(raw))
    plain = cs.derive_config(raw, "/data", "/save", 3)
    full = cs.derive_config(raw, "/data", "/save", 3, seeds=[5],
                            resume=("/r.pt", 2))
    assert raw == shipped
    for derived in (plain, full):
        assert sorted(derived) == sorted(shipped)
        for section, values in shipped.items():
            changed = cs.DERIVED_KEYS.get(section, ())
            if section == "resume" and derived is plain:
                changed = ()
            assert sorted(derived[section]) == sorted(values), section
            for key, value in values.items():
                if key not in changed:
                    assert derived[section][key] == value, (section, key)
        d = derived["dataset_config"]
        assert d["train_path"] == ["/data/train"]
        assert d["val_path"] == ["/data/val"]
        assert d["test_path"] == (["/data/test"] if shipped[
            "dataset_config"]["test_path"] else [])
        assert d["save_dir"] == "/save"
        if "dot_annotation_path" in shipped["dataset_config"]:
            assert d["dot_annotation_path"] == "/data/tsv"
        assert derived["train_config"]["epochs"] == 3
    assert plain["train_config"]["seed"] == shipped["train_config"]["seed"]
    assert full["train_config"]["seed"] == [5]
    assert full["resume"] == {"flag": True, "path": "/r.pt", "epoch": 2}
    # the derived copy is a config the port reads
    assert Config.from_dict(full).model.model_type == \
        shipped["model_config"]["model_type"]


def test_class_flips_counts_near_ties():
    """E1's card-against-CPU count on a seeded case: the pixels whose
    classes differ, those whose top two reference logits lie within the
    tolerance, and the differing pixels outside them, against a loop."""
    cs = _chip_smoke()
    rng = np.random.RandomState(4)
    ref = rng.randn(2, 9, 11, 3).astype(np.float32)
    # a few near ties: the runner-up lifted to within 1e-4 of the top
    top = ref.argmax(-1)
    for n, y, x in zip(*[rng.randint(0, s, 12) for s in (2, 9, 11)]):
        second = (top[n, y, x] + 1) % 3
        ref[n, y, x, second] = ref[n, y, x, top[n, y, x]] - 5e-5
    other = ref + rng.uniform(-1e-5, 1e-5, ref.shape).astype(np.float32)
    classes_ref = ref.argmax(-1)
    classes_other = other.argmax(-1)
    classes_other[0, 0, 0] = (classes_ref[0, 0, 0] + 1) % 3  # not a tie
    tol = 1e-4
    want_differ = want_ties = want_outside = 0
    for idx in np.ndindex(*ref.shape[:3]):
        a, b = sorted(ref[idx])[-2:]
        tie = b - a <= tol
        differ = classes_ref[idx] != classes_other[idx]
        want_ties += tie
        want_differ += differ
        want_outside += differ and not tie
    got = cs.class_flips(classes_other, classes_ref, ref, tol)
    assert got == (want_differ, want_ties, want_outside)
    assert want_ties >= 12 and want_outside == 1 and want_differ >= 1


def test_rank_device_names_the_card(monkeypatch):
    """One process on "cuda" is put on the current card by its index,
    which torch.cuda.set_device needs; "cuda:N" stands."""
    chosen = []
    monkeypatch.setattr(train_cli, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    assert train_cli.rank_device("cuda") == torch.device("cuda", 0)
    assert train_cli.rank_device("cuda:1") == torch.device("cuda", 1)
    assert train_cli.rank_device("cpu") == torch.device("cpu")
    assert chosen == [torch.device("cuda", 0), torch.device("cuda", 1)]
