"""Eval CLI of the port (counterpart of unet_torch_tpu/cli/test_cli.py).

    python -m unet_torch_tpu_torch.cli.test_cli <config.yml> \
        --checkpoint run/seedN/models/best.pt [--test-path DIR] \
        [--mode auto|single|single_crop|single_mc|reg|mt_reg] \
        [--crop-size N] [--out-dir DIR] [--device cuda]

Builds the config's model, loads the torch state_dict checkpoint (strict)
and runs the matching eval suite into <save_dir>/eval/. The device defaults
to cuda and raises where there is no GPU.

`model_type` `TransUnet`, `regression_t` or `multi_task_regTU` builds
R50-ViT-B_16 (one head, or two) at img_size = input_size[0], as the JAX CLI
does; like the JAX CLI it does not read the config's `model:` key.
"""

from __future__ import annotations

import argparse
import os

from unet_torch_tpu_torch import losses
from unet_torch_tpu_torch.ckpt import load_weights
from unet_torch_tpu_torch.cli.config import Config
from unet_torch_tpu_torch.core.device import resolve_device
from unet_torch_tpu_torch.core.precision import resolve_precision
from unet_torch_tpu_torch.data.io import get_image_list
from unet_torch_tpu_torch.eval import reports
from unet_torch_tpu_torch.models.transunet.vit import build_transunet
from unet_torch_tpu_torch.models.unet import TRANSUNET_TYPES, build_model


_MODES = ("single", "single_crop", "single_mc", "reg", "mt_reg")


def _auto_mode(model_type: str) -> str:
    if model_type in ("attention", "single", "TransUnet"):
        return "single_mc"
    if model_type in ("multi_task_regTU", "multi_task_reg"):
        return "mt_reg"
    if model_type in ("regression", "regression_t"):
        return "reg"
    raise ValueError(f"No eval mode for model_type {model_type!r}")


def run_eval(cfg: Config, checkpoint: str, test_path=None, mode="auto",
             out_dir=None, device="cuda", crop_size=256):
    m = cfg.model
    if mode == "auto":
        mode = _auto_mode(m.model_type)
    if mode not in _MODES:
        raise ValueError(f"Unknown mode {mode!r}")
    dev = resolve_device(device)
    losses.set_class_number(m.num_class)

    tpu_options = {}
    if m.remat:
        tpu_options["remat"] = True
    if m.fold:
        tpu_options["fold"] = True
    if m.model_type in TRANSUNET_TYPES:
        model = build_transunet(m.model_type, img_size=m.input_size[0],
                                num_classes=m.num_class, **tpu_options)
    else:
        model = build_model(m.model_type, n_channels=m.channel,
                            n_classes=m.num_class,
                            base=m.initial_filter_size, dropout=m.dropout,
                            dropout_p=m.drop_out_rate, **tpu_options)
    load_weights(checkpoint, model)
    dtype = resolve_precision(cfg.train.precision)
    input_size = tuple(m.input_size)

    paths = test_path or (cfg.dataset.test_path[0]
                          if cfg.dataset.test_path else None)
    if not paths:
        raise ValueError("No test path given (config test_path empty)")
    image_list = get_image_list(paths)
    out_dir = out_dir or os.path.join(cfg.dataset.save_dir, "eval")
    os.makedirs(out_dir, exist_ok=True)

    args = (model, dev, dtype, input_size, m.channel, m.num_class)
    if mode == "single_mc":
        results = reports.test_single_mc(*args, image_list, out_dir)
    elif mode == "single":
        results = reports.test_single(*args, image_list, out_dir)
    elif mode == "single_crop":
        results = reports.test_single_crop(*args, crop_size, image_list,
                                           out_dir)
    elif mode == "reg":
        results = reports.test_single_reg(*args, image_list, out_dir)
    else:
        results = reports.test_multiple_reg(*args, image_list, out_dir)
    print(results)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--test-path", default=None)
    ap.add_argument("--mode", default="auto", choices=["auto", *_MODES])
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--crop-size", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = Config.load(args.config)
    run_eval(cfg, args.checkpoint, args.test_path, args.mode, args.out_dir,
             args.device, args.crop_size)


if __name__ == "__main__":
    main()
