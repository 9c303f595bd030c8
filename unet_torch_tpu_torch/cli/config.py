"""Config schema: the reference-compatible YAML, validated (the port's own
copy of the JAX package's cli/config.py; same keys, same defaults, so one
config file drives both packages).

Parses the reference's config.yml layout verbatim (reference config.yml,
train.py:140-188): sections model_config / train_config / dataset_config /
resume, list-valued scalars indexed [0] (train.py:147-162), seed list as the
sweep axis (train.py:182-183). Beside the reference's keys:

  train_config.precision:  'f32' (default) | 'bf16'
  train_config.mesh:       {data: N, model: M}: the ranks' layout, in the
                           port as in the JAX package (the port: N * M
                           processes, core/mesh.py; {} puts every rank on
                           data)

`remat`, `fold` and `fused_head` are options of the JAX package, parsed here
with its defaults; the port recomputes the plain UNet's blocks under
`remat` (models/unet.py), and warns about and ignores the rest
(models/unet.py::ignore_tpu_options, train/steps.py).
`topo_pair_downsample` is the topo loop's pooling of the map it pairs
(train/steps.py::make_topo_steps).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import yaml


def _first(v):
    """Reference semantics: list-valued scalars are indexed [0]."""
    if isinstance(v, (list, tuple)):
        return v[0]
    return v


@dataclasses.dataclass
class ModelConfig:
    model: str = "UNet1"
    initial_filter_size: int = 64
    kernel: int = 3
    drop_out_rate: float = 0.2
    input_size: tuple = (512, 512)
    channel: int = 1
    num_class: int = 2
    model_type: str = "single"
    dropout: bool = False
    anydepth: bool = False
    # options of the JAX package (activation rematerialisation, W-folded
    # activations, loss on folded class planes): remat of the plain UNet
    # runs, the others are parsed, warned about and ignored by the port
    remat: bool = False
    fold: bool = True
    fused_head: bool = True


@dataclasses.dataclass
class TrainConfig:
    loss: str = "dice_bce"
    accuracy: str = "dice_bce"
    optimizer: str = "Adam"
    lr_rate: float = 1e-3
    adaptive_lr: bool = False
    weight_decay: float = 0.0
    batch_size: int = 2
    epochs: int = 10
    early_stop: int = 25
    num_workers: int = 0
    seeds: Sequence[int] = (0,)
    use_cuda: bool = True  # accepted for compatibility; --device decides
    precision: str = "f32"
    # the topo loop's pairing on a max-pooled map
    topo_pair_downsample: int = 1
    mesh: dict = dataclasses.field(default_factory=dict)
    # multi-process mode of the JAX package
    distributed: bool = False


@dataclasses.dataclass
class DatasetConfig:
    train_path: Sequence[str] = ()
    val_path: Sequence[str] = ()
    test_path: Sequence[str] = ()
    dot_annotation_path: Optional[str] = None
    augmentation: bool = True
    save_dir: str = "run"
    class_names: Sequence[str] = ()
    random_crop: bool = False
    # opt-in photometric augmentation for regression datasets (the reference
    # builds these pipelines but leaves them commented — DataLoader.py:285-303)
    photometric: bool = False


@dataclasses.dataclass
class ResumeConfig:
    flag: bool = False
    path: str = ""
    epoch: int = 1


@dataclasses.dataclass
class Config:
    model: ModelConfig
    train: TrainConfig
    dataset: DatasetConfig
    resume: ResumeConfig
    raw: dict

    @staticmethod
    def from_dict(cfg: dict) -> "Config":
        m = cfg.get("model_config", {})
        t = cfg.get("train_config", {})
        d = cfg.get("dataset_config", {})
        r = cfg.get("resume", {})
        model = ModelConfig(
            model=m.get("model", "UNet1"),
            initial_filter_size=int(_first(m.get("initial_filter_size", 64))),
            kernel=int(_first(m.get("kernel", 3))),
            drop_out_rate=float(_first(m.get("drop_out_rate", 0.2))),
            input_size=tuple(m.get("input_size", (512, 512))),
            channel=int(m.get("channel", 1)),
            num_class=int(m.get("num_class", 2)),
            model_type=str(m.get("model_type", "single")),
            dropout=bool(m.get("dropout", False)),
            anydepth=bool(m.get("anydepth", False)),
            remat=bool(m.get("remat", False)),
            fold=bool(m.get("fold", True)),
            fused_head=bool(m.get("fused_head", True)),
        )
        seeds = t.get("seed", [0])
        if not isinstance(seeds, (list, tuple)):
            seeds = [seeds]
        train = TrainConfig(
            loss=t.get("loss", "dice_bce"),
            accuracy=t.get("accuracy", t.get("loss", "dice_bce")),
            optimizer=t.get("optimizer", "Adam"),
            lr_rate=float(_first(t.get("lr_rate", 1e-3))),
            adaptive_lr=bool(t.get("adaptive_lr", False)),
            weight_decay=float(_first(t.get("weight_decay", 0.0))),
            batch_size=int(_first(t.get("batch_size", 2))),
            epochs=int(t.get("epochs", 10)),
            early_stop=int(t.get("early_stop", 25)),
            num_workers=int(t.get("num_workers", 0)),
            seeds=tuple(int(s) for s in seeds),
            use_cuda=bool(t.get("use_cuda", True)),
            precision=str(t.get("precision", "f32")),
            topo_pair_downsample=int(t.get("topo_pair_downsample", 1)),
            mesh=dict(t.get("mesh", {})),
            distributed=bool(t.get("distributed", False)),
        )
        dataset = DatasetConfig(
            train_path=tuple(d.get("train_path", ()) or ()),
            val_path=tuple(d.get("val_path", ()) or ()),
            test_path=tuple(d.get("test_path", ()) or ()),
            dot_annotation_path=d.get("dot_annotation_path"),
            augmentation=bool(d.get("augmentation", True)),
            save_dir=d.get("save_dir", "run"),
            class_names=tuple(d.get("class_names", ()) or ()),
            random_crop=bool(d.get("random_crop", False)),
            photometric=bool(d.get("photometric", False)),
        )
        resume = ResumeConfig(
            flag=bool(r.get("flag", False)),
            path=r.get("path", ""),
            epoch=int(r.get("epoch", 1)),
        )
        return Config(model, train, dataset, resume, cfg)

    @staticmethod
    def load(path: str) -> "Config":
        with open(path) as f:
            return Config.from_dict(yaml.safe_load(f))

    def dump_snapshot(self, save_dir: str) -> None:
        """Reference behaviour: snapshot the raw config into the run dir
        (train.py:178-179 writes YAML to config.json)."""
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "config.json"), "w") as f:
            yaml.dump(self.raw, f, default_flow_style=False)
