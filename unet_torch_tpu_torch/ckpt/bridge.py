"""The weights bridge: the JAX package's trees -> the port's state_dicts.

`state_dict_from_flax` undoes, step by step,
unet_torch_tpu/ckpt/torch_import.py::load_torch_unet (for the UNet, and for
the UNetMultitask with heads `_decod1` / `_decod2`),
`attention_state_dict_from_flax` undoes ::load_torch_unet_attention, and
`transunet_state_dict_from_flax` undoes ::load_torch_transunet:

  conv kernels        HWIO -> OIHW
  Dense kernels       (in, out) -> (out, in)
  ConvTranspose       spatial flip, then (kh,kw,I,O) -> (I,O,kh,kw)
  BN                  scale/bias -> weight/bias, mean/var -> running_mean/var,
                      num_batches_tracked = 0
  GroupNorm/LayerNorm scale/bias -> weight/bias

The trees are the `params` and `batch_stats` of the JAX `UNet`,
`UNetMultitask`, `UNetAttention` or `VisionTransformer`, as numpy arrays or anything numpy can read. The names
are the reference's, so the result loads into the port's model, and into
the reference's own.
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


def _dense(kernel) -> torch.Tensor:
    return _tensor(np.asarray(kernel).T)


def _norm(sd, prefix, p):
    sd[f"{prefix}.weight"] = _tensor(p["scale"])
    sd[f"{prefix}.bias"] = _tensor(p["bias"])


def _bn(sd, prefix, p, stats):
    _norm(sd, prefix, p)
    sd[f"{prefix}.running_mean"] = _tensor(stats["mean"])
    sd[f"{prefix}.running_var"] = _tensor(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _double_conv(sd, prefix, p, bs):
    for i, (ci, bi) in enumerate((("0", "1"), ("3", "4"))):
        sd[f"{prefix}.{ci}.weight"] = _conv(p[f"Conv_{i}"]["kernel"])
        _bn(sd, f"{prefix}.{bi}", p[f"BatchNorm_{i}"], bs[f"BatchNorm_{i}"])


def _encoder(sd, enc_p, enc_b):
    _double_conv(sd, "inc.double_conv", enc_p["inc"], enc_b["inc"])
    for i in range(1, 5):
        _double_conv(sd, f"down{i}.maxpool_conv.1.double_conv",
                     enc_p[f"down{i}"]["DoubleConv_0"],
                     enc_b[f"down{i}"]["DoubleConv_0"])


def _decoder(sd, dec_p, dec_b, suffix=""):
    """up1..4 and outc of one decoder; `suffix` is the reference's head
    suffix (`_decod1`, `_decod2`) or empty."""
    for i in range(1, 5):
        up = dec_p[f"up{i}"]
        sd[f"up{i}{suffix}.up.weight"] = _conv_t(up["ConvTranspose_0"]["kernel"])
        sd[f"up{i}{suffix}.up.bias"] = _tensor(up["ConvTranspose_0"]["bias"])
        _double_conv(sd, f"up{i}{suffix}.conv.double_conv",
                     up["DoubleConv_0"], dec_b[f"up{i}"]["DoubleConv_0"])
    sd[f"outc{suffix}.conv.weight"] = _conv(dec_p["outc"]["Conv_0"]["kernel"])
    sd[f"outc{suffix}.conv.bias"] = _tensor(dec_p["outc"]["Conv_0"]["bias"])


def state_dict_from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """The port's UNet state_dict from a JAX UNet's (params, batch_stats), or
    the port's UNetMultitask state_dict from a JAX UNetMultitask's (trees
    with `decoder1` and `decoder2`)."""
    sd: dict[str, torch.Tensor] = {}
    _encoder(sd, params["encoder"], batch_stats["encoder"])
    if "decoder" in params:
        _decoder(sd, params["decoder"], batch_stats["decoder"])
    else:
        for n in (1, 2):
            _decoder(sd, params[f"decoder{n}"], batch_stats[f"decoder{n}"],
                     f"_decod{n}")
    return sd


def attention_state_dict_from_flax(params,
                                   batch_stats) -> dict[str, torch.Tensor]:
    """The port's UNetAttention state_dict from a JAX UNetAttention's
    (params, batch_stats): the up blocks and the head sit at the top of the
    trees, the gates `att1..4` become the reference's `attenion1..4`."""
    sd: dict[str, torch.Tensor] = {}
    _encoder(sd, params["encoder"], batch_stats["encoder"])
    _decoder(sd, params, batch_stats)
    for i in range(1, 5):
        gp, gb, name = params[f"att{i}"], batch_stats[f"att{i}"], f"attenion{i}"
        sd[f"{name}.up.weight"] = _conv_t(gp["ConvTranspose_0"]["kernel"])
        sd[f"{name}.up.bias"] = _tensor(gp["ConvTranspose_0"]["bias"])
        for proj in ("W_q", "W_x", "psi"):
            sd[f"{name}.{proj}.0.weight"] = _conv(gp[f"{proj}_conv"]["kernel"])
            sd[f"{name}.{proj}.0.bias"] = _tensor(gp[f"{proj}_conv"]["bias"])
            _bn(sd, f"{name}.{proj}.1", gp[f"{proj}_bn"], gb[f"{proj}_bn"])
    return sd


def _conv2d_relu(sd, prefix, p, bs):
    sd[f"{prefix}.0.weight"] = _conv(p["conv"]["kernel"])
    _bn(sd, f"{prefix}.1", p["bn"], bs["bn"])


def transunet_state_dict_from_flax(params,
                                   batch_stats) -> dict[str, torch.Tensor]:
    """The port's VisionTransformer state_dict from a JAX VisionTransformer's
    (params, batch_stats); the folded decoder tail has the same trees."""
    sd: dict[str, torch.Tensor] = {}
    emb = params["transformer"]["embeddings"]
    base = "transformer.embeddings"
    sd[f"{base}.patch_embeddings.weight"] = _conv(
        emb["patch_embeddings"]["kernel"])
    sd[f"{base}.patch_embeddings.bias"] = _tensor(
        emb["patch_embeddings"]["bias"])
    sd[f"{base}.position_embeddings"] = _tensor(emb["position_embeddings"])
    if "hybrid_model" in emb:
        hm, hb = emb["hybrid_model"], f"{base}.hybrid_model"
        sd[f"{hb}.root.conv.weight"] = _conv(hm["root_conv"]["kernel"])
        _norm(sd, f"{hb}.root.gn", hm["root_gn"])
        for key, unit in hm.items():
            if not key.startswith("block"):
                continue
            b, u = key[len("block"):].split("_unit")
            ub = f"{hb}.body.block{b}.unit{u}"
            for conv in ("conv1", "conv2", "conv3"):
                sd[f"{ub}.{conv}.weight"] = _conv(unit[conv]["kernel"])
            for gn in ("gn1", "gn2", "gn3"):
                _norm(sd, f"{ub}.{gn}", unit[gn])
            if "downsample" in unit:
                sd[f"{ub}.downsample.weight"] = _conv(
                    unit["downsample"]["kernel"])
                _norm(sd, f"{ub}.gn_proj", unit["gn_proj"])

    enc = params["transformer"]["encoder"]
    i = 0
    while f"encoderblock_{i}" in enc:
        blk, lb = enc[f"encoderblock_{i}"], f"transformer.encoder.layer.{i}"
        for ln in ("attention_norm", "ffn_norm"):
            _norm(sd, f"{lb}.{ln}", blk[ln])
        for name in ("query", "key", "value", "out"):
            sd[f"{lb}.attn.{name}.weight"] = _dense(blk["attn"][name]["kernel"])
            sd[f"{lb}.attn.{name}.bias"] = _tensor(blk["attn"][name]["bias"])
        for fc in ("fc1", "fc2"):
            sd[f"{lb}.ffn.{fc}.weight"] = _dense(blk["ffn"][fc]["kernel"])
            sd[f"{lb}.ffn.{fc}.bias"] = _tensor(blk["ffn"][fc]["bias"])
        i += 1
    _norm(sd, "transformer.encoder.encoder_norm", enc["encoder_norm"])

    dec_p, dec_b = params["decoder"], batch_stats["decoder"]
    _conv2d_relu(sd, "decoder.conv_more", dec_p["conv_more"],
                 dec_b["conv_more"])
    i = 0
    while f"block_{i}" in dec_p:
        for conv in ("conv1", "conv2"):
            _conv2d_relu(sd, f"decoder.blocks.{i}.{conv}",
                         dec_p[f"block_{i}"][conv], dec_b[f"block_{i}"][conv])
        i += 1
    head = params["segmentation_head"]["conv"]
    sd["segmentation_head.0.weight"] = _conv(head["kernel"])
    sd["segmentation_head.0.bias"] = _tensor(head["bias"])
    return sd
