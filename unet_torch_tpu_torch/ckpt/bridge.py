"""The weights bridge: the JAX package's UNet trees -> the port's state_dict.

`state_dict_from_flax` undoes, step by step,
unet_torch_tpu/ckpt/torch_import.py::load_torch_unet:

  conv kernels        HWIO -> OIHW
  ConvTranspose       spatial flip, then (kh,kw,I,O) -> (I,O,kh,kw)
  BN                  scale/bias -> weight/bias, mean/var -> running_mean/var,
                      num_batches_tracked = 0

The trees are the `params` and `batch_stats` of the JAX `UNet`, as numpy
arrays or anything numpy can read. The names are the reference's, so the
result loads into the port's UNet, and into the reference's own model.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:
    return _tensor(np.asarray(kernel).transpose(3, 2, 0, 1))


def _conv_t(kernel) -> torch.Tensor:
    return _tensor(np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1))


def _double_conv(sd, prefix, p, bs):
    for i, (ci, bi) in enumerate((("0", "1"), ("3", "4"))):
        sd[f"{prefix}.{ci}.weight"] = _conv(p[f"Conv_{i}"]["kernel"])
        bn, stats = p[f"BatchNorm_{i}"], bs[f"BatchNorm_{i}"]
        sd[f"{prefix}.{bi}.weight"] = _tensor(bn["scale"])
        sd[f"{prefix}.{bi}.bias"] = _tensor(bn["bias"])
        sd[f"{prefix}.{bi}.running_mean"] = _tensor(stats["mean"])
        sd[f"{prefix}.{bi}.running_var"] = _tensor(stats["var"])
        sd[f"{prefix}.{bi}.num_batches_tracked"] = torch.tensor(0)


def state_dict_from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """The port's UNet state_dict from a JAX UNet's (params, batch_stats)."""
    sd: dict[str, torch.Tensor] = {}
    enc_p, enc_b = params["encoder"], batch_stats["encoder"]
    _double_conv(sd, "inc.double_conv", enc_p["inc"], enc_b["inc"])
    for i in range(1, 5):
        _double_conv(sd, f"down{i}.maxpool_conv.1.double_conv",
                     enc_p[f"down{i}"]["DoubleConv_0"],
                     enc_b[f"down{i}"]["DoubleConv_0"])
    dec_p, dec_b = params["decoder"], batch_stats["decoder"]
    for i in range(1, 5):
        up = dec_p[f"up{i}"]
        sd[f"up{i}.up.weight"] = _conv_t(up["ConvTranspose_0"]["kernel"])
        sd[f"up{i}.up.bias"] = _tensor(up["ConvTranspose_0"]["bias"])
        _double_conv(sd, f"up{i}.conv.double_conv", up["DoubleConv_0"],
                     dec_b[f"up{i}"]["DoubleConv_0"])
    sd["outc.conv.weight"] = _conv(dec_p["outc"]["Conv_0"]["kernel"])
    sd["outc.conv.bias"] = _tensor(dec_p["outc"]["Conv_0"]["bias"])
    return sd
