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
`UNetMultitask`, `UNetAttention`, `VisionTransformer` or its multi-head
variants, as numpy arrays or anything numpy can read. The names
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


def _decoder_cup(sd, prefix, dec_p, dec_b):
    _conv2d_relu(sd, f"{prefix}.conv_more", dec_p["conv_more"],
                 dec_b["conv_more"])
    i = 0
    while f"block_{i}" in dec_p:
        for conv in ("conv1", "conv2"):
            _conv2d_relu(sd, f"{prefix}.blocks.{i}.{conv}",
                         dec_p[f"block_{i}"][conv], dec_b[f"block_{i}"][conv])
        i += 1


def transunet_state_dict_from_flax(params,
                                   batch_stats) -> dict[str, torch.Tensor]:
    """The port's state_dict of a TransUnet from the JAX model's (params,
    batch_stats): a VisionTransformer's (`decoder`, `segmentation_head`; the
    folded decoder tail has the same trees), a VisionTransformerMultitask's
    or ...MultitaskEM's (`decoder{i}`, `segmentation_head{i}`, i from 1).
    Params of the uncertainty-weighted loop, {"model": params, "log_vars":
    (2,)} as the JAX trainer keeps them, give `log_vars` too."""
    sd: dict[str, torch.Tensor] = {}
    if "log_vars" in params:
        sd["log_vars"] = _tensor(params["log_vars"])
        params = params["model"]
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

    suffixes = [""] if "decoder" in params else [
        str(i) for i in range(1, 7) if f"decoder{i}" in params]
    for s in suffixes:
        _decoder_cup(sd, f"decoder{s}", params[f"decoder{s}"],
                     batch_stats[f"decoder{s}"])
        head = params[f"segmentation_head{s}"]["conv"]
        sd[f"segmentation_head{s}.0.weight"] = _conv(head["kernel"])
        sd[f"segmentation_head{s}.0.bias"] = _tensor(head["bias"])
    return sd


# ---------------------------------------------------------------------------
# CLTR (ConditionalDETR)
# ---------------------------------------------------------------------------

_FROZEN_BN = ("weight", "bias", "running_mean", "running_var")


def _cltr_entries(params):
    """Every tensor of a JAX ConditionalDETR (or DETRsegm) as (tree, path,
    state_dict name, kind): `tree` is "params" or "batch_stats" (the
    frozen-BN tensors, named after the params' layers), `kind` how the array
    turns into the port's tensor (`conv` HWIO -> OIHW, `dense` transposed,
    `raw` as it is). The encoder's q/k/v projections are left out: they
    stack into `in_proj_weight` and `in_proj_bias`."""
    def dense(path, name):
        yield "params", path + ("kernel",), f"{name}.weight", "dense"
        yield "params", path + ("bias",), f"{name}.bias", "raw"

    def norm(path, name):
        yield "params", path + ("scale",), f"{name}.weight", "raw"
        yield "params", path + ("bias",), f"{name}.bias", "raw"

    def mlp(path, name, tree):
        for key in sorted(tree):
            yield from dense(path + (key,),
                             f"{name}.layers.{key[len('layer'):]}")

    def frozen_bn(path, name):
        for key in _FROZEN_BN:
            yield "batch_stats", path + (key,), f"{name}.{key}", "raw"

    bb = params["backbone"]
    yield "params", ("backbone", "conv1", "kernel"), "backbone.conv1.weight", \
        "conv"
    yield from frozen_bn(("backbone", "bn1"), "backbone.bn1")
    for key in sorted(k for k in bb if k.startswith("layer")):
        li, b = key[len("layer"):].split("_block")
        path, name = ("backbone", key), f"backbone.layer{li}.{b}"
        for i in "123":
            yield "params", path + (f"conv{i}", "kernel"), \
                f"{name}.conv{i}.weight", "conv"
            yield from frozen_bn(path + (f"bn{i}",), f"{name}.bn{i}")
        if "downsample_conv" in bb[key]:
            yield "params", path + ("downsample_conv", "kernel"), \
                f"{name}.downsample.0.weight", "conv"
            yield from frozen_bn(path + ("downsample_bn",),
                                 f"{name}.downsample.1")
    yield "params", ("input_proj", "kernel"), "input_proj.weight", "conv"
    yield "params", ("input_proj", "bias"), "input_proj.bias", "raw"
    yield "params", ("query_embed",), "query_embed.weight", "raw"
    if "pos_embed" in params:
        for emb in ("row_embed", "col_embed"):
            yield "params", ("pos_embed", emb, "embedding"), \
                f"pos_embed.{emb}.weight", "raw"
    yield from dense(("class_embed",), "class_embed")
    yield from mlp(("point_embed",), "point_embed", params["point_embed"])
    if "mask_head" in params:  # a DETRsegm's trees
        for proj in ("q_linear", "k_linear"):
            yield from dense(("bbox_attention", proj),
                             f"bbox_attention.{proj}")
        for key in sorted(params["mask_head"]):
            path, name = ("mask_head", key), f"mask_head.{key}"
            if key.startswith("gn"):
                yield from norm(path, name)
            else:
                yield "params", path + ("kernel",), f"{name}.weight", "conv"
                yield "params", path + ("bias",), f"{name}.bias", "raw"

    tr = params["transformer"]
    for key in sorted(tr):
        path = ("transformer", key)
        if key.startswith("encoder_layer"):
            name = f"transformer.encoder.layers.{key[len('encoder_layer'):]}"
            yield from dense(path + ("self_attn", "out_proj"),
                             f"{name}.self_attn.out_proj")
            subs = ("linear1", "linear2")
            norms = ("norm1", "norm2")
        elif key.startswith("decoder_layer"):
            name = f"transformer.decoder.layers.{key[len('decoder_layer'):]}"
            for attn in ("self_attn", "cross_attn"):
                yield from dense(path + (attn, "out_proj"),
                                 f"{name}.{attn}.out_proj")
            subs = sorted(k for k in tr[key]
                          if k.startswith(("sa_", "ca_", "linear")))
            norms = ("norm1", "norm2", "norm3")
        else:
            continue
        for sub in subs:
            yield from dense(path + (sub,), f"{name}.{sub}")
        for n in norms:
            yield from norm(path + (n,), f"{name}.{n}")
    yield from norm(("transformer", "decoder_norm"),
                    "transformer.decoder.norm")
    for head in ("ref_point_head", "query_scale"):
        yield from mlp(("transformer", head), f"transformer.decoder.{head}",
                       tr[head])


def _encoder_attn_names(params):
    for key in sorted(params["transformer"]):
        if key.startswith("encoder_layer"):
            yield (params["transformer"][key]["self_attn"],
                   f"transformer.encoder.layers.{key[len('encoder_layer'):]}"
                   ".self_attn")


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def cltr_state_dict_from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """The port's ConditionalDETR (or DETRsegm) state_dict from the JAX
    model's (params, batch_stats). The frozen-BN tensors of `batch_stats`
    become the backbone's buffers under torchvision's names; the encoder's
    q, k and v projections stack into `in_proj_weight` / `in_proj_bias`,
    the reference's layout."""
    trees = {"params": params, "batch_stats": batch_stats}
    to_tensor = {"conv": _conv, "dense": _dense, "raw": _tensor}
    sd = {name: to_tensor[kind](_get(trees[tree], path))
          for tree, path, name, kind in _cltr_entries(params)}
    for attn, name in _encoder_attn_names(params):
        projs = [attn[p] for p in ("q_proj", "k_proj", "v_proj")]
        sd[f"{name}.in_proj_weight"] = torch.cat(
            [_dense(p["kernel"]) for p in projs])
        sd[f"{name}.in_proj_bias"] = torch.cat(
            [_tensor(p["bias"]) for p in projs])
    return sd


def cltr_flax_from_state_dict(state_dict, params, batch_stats):
    """The inverse: fill copies of a JAX ConditionalDETR's (params,
    batch_stats) trees, as numpy, from the port's state_dict. A round trip
    through both is exact."""
    def copy(tree):
        return ({k: copy(v) for k, v in tree.items()}
                if isinstance(tree, dict) else np.array(tree))

    trees = {"params": copy(params), "batch_stats": copy(batch_stats)}
    from_tensor = {"conv": lambda w: w.transpose(2, 3, 1, 0),
                   "dense": lambda w: w.T, "raw": lambda w: w}
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    for tree, path, name, kind in _cltr_entries(params):
        _get(trees[tree], path[:-1])[path[-1]] = np.ascontiguousarray(
            from_tensor[kind](sd[name]))
    for attn, name in _encoder_attn_names(trees["params"]):
        weights = np.split(sd[f"{name}.in_proj_weight"], 3)
        biases = np.split(sd[f"{name}.in_proj_bias"], 3)
        for proj, w, b in zip(("q_proj", "k_proj", "v_proj"), weights,
                              biases):
            attn[proj]["kernel"] = np.ascontiguousarray(w.T)
            attn[proj]["bias"] = b.copy()
    return trees["params"], trees["batch_stats"]


def load_pretrained_resnet50(model, state_dict, prefix: str = "") -> None:
    """Install a torchvision-layout resnet50 state_dict as `model.backbone`'s
    weights and frozen-BN buffers, in place. Only keys under `prefix` (for
    example "backbone.0.body.") are taken, with it stripped; the classifier
    (`fc.*`) and `num_batches_tracked` are dropped; everything else must
    match the backbone strictly."""
    sd = {k[len(prefix):]: torch.as_tensor(v).float()
          for k, v in state_dict.items() if k.startswith(prefix)}
    sd = {k: v for k, v in sd.items()
          if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    model.backbone.load_state_dict(sd, strict=True)
