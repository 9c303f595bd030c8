"""Train CLI of the port (counterpart of unet_torch_tpu/cli/train_cli.py).

    python -m unet_torch_tpu_torch.cli.train_cli <config.yml> [--device cuda]
    torchrun --nproc_per_node=N -m unet_torch_tpu_torch.cli.train_cli \
        <config.yml> [--backend nccl|gloo]

The reference's run: a seed sweep with one directory per seed
(`save_dir/<basename>_seed{N}`), the config snapshot (`config.json`), resume
from a port checkpoint (`resume.flag`, `resume.path` a torch state_dict,
training from `resume.epoch`), `Trainer.train`, the post-train test of the
best model, pruning of the epoch checkpoints and the cross-seed
`results.csv`. The device defaults to cuda and raises where there is no GPU;
`--device cpu` runs the plain versions of the kernels.

  model_type                dataset         loop                 post-train test
  single, attention         DataBinary      single_train         test_single (num_class <= 2) or test_single_mc
  TransUnet                 DataBinary      single_train         as single
  (those three under a topo loss: DataBinary with dot maps, single_train_wup)
  regression, regression_t  DataReg         single_train (ReLU)  test_single_reg
  multi_task                DataRegBinary   two-head loop        none
  multi_task_reg,           DataRegMT       two-head loop        test_multiple_reg
    multi_task_regTU
  CLTR                      DataPointReg    cltr_train_loop      none

`TransUnet`, `regression_t` and `multi_task_regTU` build R50-ViT-B/16
(models/transunet/vit.py::build_transunet) and, where the file
`model_config.pretrained_npz` (default `TransUnet/R50+ViT-B_16.npz`)
exists, load Google's ViT weights from it into the fresh model
(models/transunet/npz.py), before a resume checkpoint is loaded over it.
`multitask_em` builds but has no loop: it raises ValueError, as in the JAX
CLI.

`CLTR` reads the flat `cltr_config` keys (model sizes, loss coefficients,
`crop_size`, `num_knn`, `dot_shape`, `clip_max_norm`, `pretrained_resnet50`:
a torchvision resnet50 state_dict for a fresh model's backbone, installed
before a resume checkpoint is loaded);
`train_config.precision` is its compute dtype unless `cltr_config` names one.
Its train loader flattens the per-image crops (`cltr_collate`), its val
loader yields one image's tiled patches at a time.

The curves (`total.png`) and the post-train test's plots are drawn with
matplotlib. Where it cannot be imported, the run draws none of them and
writes everything else all the same: checkpoints, logs, the post-train
test's CSVs and `results.csv` (eval/results.py::_plt).

Under a topological loss (`TOPO_LOSS_NAMES`) the single-head types read
their dot maps too (`DataBinary(return_gt_dot=True)`) and train in the
warm-up loop (`single_train_wup`, pairing on a max-pooled map with
`train_config.topo_pair_downsample`).

Datasets and loaders are the port's numpy ones (data/). `random_crop`
raises NotImplementedError with the reason (core/not_ported.py).

Several processes: a launch with WORLD_SIZE > 1 (torchrun) or
`distributed: true` starts torch.distributed (core/dist.py; NCCL with a card
a rank, gloo on the CPU or where `--backend gloo` puts ranks on one card)
and lays the ranks out as `train_config.mesh` says ({} puts every rank on
`data`; {data: D, model: M} needs D * M ranks): rank d * M + m loads shard
d of the train set at `batch_size // D` images a step, the transformer
types split their heads and MLPs over the M ranks of one d, and every loop
trains through DistributedDataParallel over the D ranks of one m (the same
model as one process on the global batch; train/trainer.py). Each rank runs
on cuda:LOCAL_RANK unless `--device` names a card. Rank 0 alone writes the
config snapshot, the logs, the checkpoints (full, unsharded state dicts),
the post-train test and `results.csv`. `distributed: true` without a
launcher, a mesh whose product is not the number of ranks and NCCL with
more ranks than cards on a host raise with the reason, before anything is
written.
"""

from __future__ import annotations

import argparse
import glob as globmod
import importlib.util
import os

import numpy as np
import torch

from unet_torch_tpu_torch import losses
from unet_torch_tpu_torch.ckpt import (
    load_pretrained_resnet50,
    load_resnet50_checkpoint,
    load_weights,
)
from unet_torch_tpu_torch.cli.config import Config
from unet_torch_tpu_torch.core import not_ported
from unet_torch_tpu_torch.core.device import resolve_device
from unet_torch_tpu_torch.core.dist import (
    is_main,
    local_rank,
    maybe_initialize,
    process_count,
    shutdown,
)
from unet_torch_tpu_torch.core.mesh import mesh_from_config
from unet_torch_tpu_torch.core.precision import resolve_precision
from unet_torch_tpu_torch.core.rng import seed_everything
from unet_torch_tpu_torch.data.datasets import (
    DataBinary,
    DataPointReg,
    DataReg,
    DataRegBinary,
    DataRegMT,
)
from unet_torch_tpu_torch.data.io import get_image_list
from unet_torch_tpu_torch.data.loader import NumpyLoader
from unet_torch_tpu_torch.eval import reports
from unet_torch_tpu_torch.models.cltr.model import build_cltr
from unet_torch_tpu_torch.models.transunet.npz import load_npz_into_model
from unet_torch_tpu_torch.models.transunet.vit import build_transunet
from unet_torch_tpu_torch.models.unet import TRANSUNET_TYPES, build_model
from unet_torch_tpu_torch.train.cltr_loop import cltr_collate
from unet_torch_tpu_torch.train.trainer import TOPO_LOSS_NAMES, Trainer

# the JAX CLI loads Google's ViT weights from here when the file exists
_DEFAULT_NPZ = "TransUnet/R50+ViT-B_16.npz"


def _tpu_options(m) -> dict:
    options = {}
    if m.remat:
        options["remat"] = True
    if m.fold:
        options["fold"] = True
    return options


def get_points_from_tsv(tsv_path):
    """Map image stem -> tsv annotation path."""
    if not tsv_path:
        return {}
    dataset = {}
    for label in globmod.glob(os.path.join(tsv_path, "*.tsv")):
        name = label.split(".tsv")[0].split(".png-points")[0].split("/")[-1]
        name = name.split("-he")[0].split("-HE")[0].split("/")[-1]
        dataset[name] = label
    return dataset


def load_pretrained_npz(model, cfg: Config) -> None:
    """Google's ViT weights into a TransUnet from the file
    `model_config.pretrained_npz` (default `TransUnet/R50+ViT-B_16.npz`),
    where it exists, as the JAX CLI loads them."""
    path = cfg.raw.get("model_config", {}).get("pretrained_npz", _DEFAULT_NPZ)
    if os.path.exists(path):
        with np.load(path) as weights:
            load_npz_into_model(model, weights)
        print(f"loaded pretrained weights from {path}")


def build_datasets_and_model(cfg: Config, seed: int, generator=None):
    """(train dataset, val dataset, model) by `model_type`; the model's
    weights are drawn from `generator`. A CLTR model carries its criterion
    as `model.criterion`."""
    m, d = cfg.model, cfg.dataset
    mt = m.model_type
    not_ported.check(not_ported.MODEL_TYPES, "model_type", mt)
    input_size = tuple(m.input_size)
    common = dict(ch=m.channel, anydepth=m.anydepth, seed=seed,
                  input_size=input_size)
    if mt in ("single", "attention", "TransUnet"):
        if mt == "TransUnet" and d.random_crop:
            not_ported.check(not_ported.TRAIN_OPTIONS, "option", "random_crop")
        needs_dot = cfg.train.loss in TOPO_LOSS_NAMES
        train_ds = DataBinary(list(d.train_path), augmentation=d.augmentation,
                              return_gt_dot=needs_dot, **common)
        val_ds = DataBinary(list(d.val_path), augmentation=False,
                            return_gt_dot=needs_dot, **common)
    elif mt in ("regression", "regression_t"):
        train_ds = DataReg(list(d.train_path), augmentation=d.augmentation,
                           photometric=d.photometric, **common)
        val_ds = DataReg(list(d.val_path), augmentation=False, **common)
    elif mt == "multi_task":
        train_ds = DataRegBinary(list(d.train_path), **common)
        val_ds = DataRegBinary(list(d.val_path), **common)
    elif mt in ("multi_task_reg", "multi_task_regTU"):
        train_ds = DataRegMT(list(d.train_path), augmentation=d.augmentation,
                             **common)
        val_ds = DataRegMT(list(d.val_path), augmentation=False, **common)
    elif mt == "CLTR":
        tsv_files = get_points_from_tsv(d.dot_annotation_path)
        cltr_args = dict(cfg.raw.get("cltr_config", {}))
        point_kw = dict(
            ch=m.channel, anydepth=m.anydepth, seed=seed,
            crop_size=int(cltr_args.get("crop_size", 256)),
            num_knn=int(cltr_args.get("num_knn", 4)),
            dot_shape=tuple(cltr_args.get("dot_shape", (768, 768))))
        train_ds = DataPointReg(list(d.train_path), tsv_files,
                                augmentation=d.augmentation, train=True,
                                **point_kw)
        val_ds = DataPointReg(list(d.val_path), tsv_files, augmentation=False,
                              train=False, **point_kw)
    else:
        raise ValueError(f'Invalid model_type "{mt}"')
    if mt in TRANSUNET_TYPES:
        model = build_transunet(mt, img_size=input_size[0],
                                num_classes=m.num_class, generator=generator,
                                **_tpu_options(m))
        # a fresh model only: a resumed run loads its checkpoint over it
        load_pretrained_npz(model, cfg)
    elif mt == "CLTR":
        cltr_args.setdefault("precision", cfg.train.precision)
        model, criterion, _ = build_cltr(cltr_args, generator)
        model.criterion = criterion
        # a fresh model's backbone only: a resumed run loads its checkpoint
        # over it afterwards
        pretrained = cltr_args.get("pretrained_resnet50")
        if pretrained:
            load_pretrained_resnet50(model,
                                     load_resnet50_checkpoint(pretrained))
            print(f"loaded pretrained resnet50 from {pretrained}")
    else:
        model = build_model(mt, n_channels=m.channel, n_classes=m.num_class,
                            base=m.initial_filter_size, dropout=m.dropout,
                            dropout_p=m.drop_out_rate, generator=generator,
                            **_tpu_options(m))
    return train_ds, val_ds, model


def rank_device(device: str = "cuda") -> torch.device:
    """The rank's device: a launch of several ranks runs each on
    cuda:LOCAL_RANK where `device` is "cuda", one process on the current
    card; "cuda:N" and "cpu" stand. A card is named by its index, which
    torch.cuda.set_device needs."""
    if device == "cuda" and process_count() > 1:
        device = f"cuda:{local_rank()}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return dev


def run_training(cfg: Config, device="cuda", backend=None):
    maybe_initialize(force=cfg.train.distributed, backend=backend)
    mesh = mesh_from_config(cfg.train.mesh)
    if mesh.size == 1:
        mesh = None  # one process: the single-device path
    dev = rank_device(device)
    plot = importlib.util.find_spec("matplotlib") is not None
    if not plot and is_main():
        print("matplotlib cannot be imported: the curves (total.png) are "
              "not drawn")
    dtype = resolve_precision(cfg.train.precision)
    losses.set_class_number(cfg.model.num_class)
    save_dir = cfg.dataset.save_dir
    if is_main():
        os.makedirs(save_dir, exist_ok=True)
        cfg.dump_snapshot(save_dir)
    # each rank loads its shard of the train set at its share of the batch
    batch, shard_kw = cfg.train.batch_size, {}
    if mesh is not None and mesh.data > 1:
        batch = mesh.local_batch(batch)
        shard_kw = {"shard_index": mesh.d, "num_shards": mesh.data}
    test_image_list = (get_image_list(cfg.dataset.test_path[0])
                       if cfg.dataset.test_path else [])
    results, trainers = {}, {}

    for seed in cfg.train.seeds:
        out_dir = os.path.join(save_dir,
                               f"{os.path.basename(save_dir)}_seed{seed}")
        os.makedirs(out_dir, exist_ok=True)
        generator = seed_everything(seed)
        train_ds, val_ds, model = build_datasets_and_model(cfg, seed,
                                                           generator)
        if cfg.resume.flag:
            load_weights(cfg.resume.path, model)
        print(f"Train set size: {len(train_ds)}")
        print(f"Val set size: {len(val_ds)}")
        print(f"Loss Function: {cfg.train.loss}")
        is_cltr = cfg.model.model_type == "CLTR"
        dataloaders = {
            "train": NumpyLoader(train_ds, batch, shuffle=True, seed=seed,
                                 num_workers=cfg.train.num_workers,
                                 **({"collate_fn": cltr_collate}
                                    if is_cltr else {}), **shard_kw),
            "val": NumpyLoader(val_ds, 1, shuffle=False,
                               **({"collate_fn": lambda items: items[0]}
                                  if is_cltr else {})),
        }
        trainer = Trainer(
            model, cfg.model.model_type, out_dir, dataloaders,
            cfg.train.batch_size, cfg.train.optimizer, cfg.train.lr_rate,
            cfg.train.weight_decay, patience=cfg.train.early_stop,
            num_epochs=cfg.train.epochs, loss_function=cfg.train.loss,
            accuracy_metric=cfg.train.accuracy,
            num_classes=cfg.model.num_class,
            lr_scheduler=cfg.train.adaptive_lr,
            start_epoch=cfg.resume.epoch if cfg.resume.flag else 1,
            seed=seed, fused_head=cfg.model.fused_head,
            topo_pair_downsample=cfg.train.topo_pair_downsample, device=dev,
            dtype=dtype, plot=plot, mesh=mesh)
        if is_cltr:
            cltr_args = cfg.raw.get("cltr_config", {})
            trainer.criterion = model.criterion
            trainer.cltr_clip_max_norm = float(
                cltr_args.get("clip_max_norm", 0.0))
        trainer.train()
        trainers[seed] = trainer

        if not test_image_list:
            continue
        # a tensor-parallel model is served whole, from the gathered state
        state = (trainer.full_state()
                 if mesh is not None and mesh.model > 1 else None)
        if is_main():
            print("Testing best model:")
            model = (trainer.model if state is None
                     else _whole_model(cfg, seed, state, dev))
            results[seed] = _post_train_test(model, trainer, cfg,
                                             test_image_list, out_dir)
            _delete_non_best(out_dir)

    if results and is_main():
        import pandas as pd

        df = pd.DataFrame(results).transpose().sort_index()
        df.to_csv(os.path.join(save_dir, "results.csv"))
    return trainers, results


def _whole_model(cfg: Config, seed: int, state: dict, device):
    """A model of the config built in one process, holding `state` (a full
    state dict) on `device`."""
    model = build_datasets_and_model(cfg, seed,
                                     torch.Generator().manual_seed(seed))[2]
    if "log_vars" in state and hasattr(model, "add_log_vars"):
        model.add_log_vars()
    model.load_state_dict(state, strict=True)
    return model.to(device)


def _post_train_test(model, trainer, cfg: Config, test_image_list, out_dir):
    """The best model through the eval suite of its model type into
    `out_dir`; `multi_task` has none, as in the JAX CLI."""
    m = cfg.model
    mt = m.model_type
    args = (model, trainer.device, trainer.dtype,
            tuple(m.input_size), m.channel, m.num_class, test_image_list,
            out_dir)
    tsv_files = get_points_from_tsv(cfg.dataset.dot_annotation_path)
    if mt in ("attention", "single", "TransUnet"):
        if m.num_class <= 2:
            return reports.test_single(*args)
        return reports.test_single_mc(*args)
    if mt in ("multi_task_reg", "multi_task_regTU"):
        return reports.test_multiple_reg(*args, tsv_files=tsv_files)
    if mt in ("regression", "regression_t"):
        return reports.test_single_reg(*args, tsv_files=tsv_files)
    return {}


def _delete_non_best(out_dir):
    """Prune the epoch checkpoints, keep best.pt and last_epoch.pt; one that
    cannot be deleted is reported and kept, as in the JAX CLI, so that the
    sweep goes on to its results.csv."""
    for path in globmod.glob(os.path.join(out_dir, "models", "*epoch*")):
        if os.path.basename(path) == "last_epoch.pt":
            continue
        try:
            os.remove(path)
        except OSError as e:
            print(f"Error deleting {path}: {e}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="the config path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend of a launch: nccl (a "
                         "card a rank, the default with a card) or gloo")
    args = ap.parse_args(argv)
    try:
        return run_training(Config.load(args.config), device=args.device,
                            backend=args.backend)
    finally:
        shutdown()


if __name__ == "__main__":
    main()
