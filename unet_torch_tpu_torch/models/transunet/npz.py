"""Google's ViT checkpoints (`R50+ViT-B_16.npz`) into a TransUnet
(counterpart of unet_torch_tpu/models/transunet/vit.py::load_npz_into_params,
which mirrors the reference's `VisionTransformer.load_from`).

The `.npz` holds JAX-layout arrays, which go into the model's `transformer`
as the reference's `np2th` turns them into torch's layout:

  conv kernels      HWIO -> OIHW
  dense kernels     (in, out) -> (out, in); the q, k and v kernels
                    (hidden, heads, d) and the out kernel (heads, d, hidden)
                    are reshaped to (hidden, hidden) first
  biases, norms     flattened

The position embeddings are copied as they are when the token counts agree,
without the class token when the checkpoint has one more, and otherwise
re-gridded with `scipy.ndimage.zoom(order=1)` (14 x 14 -> 32 x 32 at a
512 x 512 input). The decoders and heads keep their weights, so one loader
serves the single-head and the multi-head models.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _conv(kernel) -> np.ndarray:
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def _flat(a) -> np.ndarray:
    return np.asarray(a).reshape(-1)


def _position_embeddings(posemb, n_tokens: int) -> np.ndarray:
    """The checkpoint's (1, N, hidden) position embeddings for n_tokens."""
    from scipy import ndimage

    posemb = np.asarray(posemb)
    if posemb.shape[1] == n_tokens:
        return posemb
    if posemb.shape[1] - 1 == n_tokens:
        return posemb[:, 1:]
    grid = posemb[0, 1:]
    gs_old = int(np.sqrt(len(grid)))
    gs_new = int(np.sqrt(n_tokens))
    grid = grid.reshape(gs_old, gs_old, -1)
    zoom = (gs_new / gs_old, gs_new / gs_old, 1)
    grid = ndimage.zoom(grid, zoom, order=1)
    return grid.reshape(1, gs_new * gs_new, -1)


def _entries(model: nn.Module, weights):
    """(state_dict name, array in torch's layout) for every tensor of the
    model's `transformer` that the checkpoint fills."""
    emb = model.transformer.embeddings
    hidden = emb.position_embeddings.shape[-1]
    base = "transformer.embeddings"
    yield f"{base}.patch_embeddings.weight", _conv(weights["embedding/kernel"])
    yield f"{base}.patch_embeddings.bias", weights["embedding/bias"]
    yield f"{base}.position_embeddings", _position_embeddings(
        weights["Transformer/posembed_input/pos_embedding"],
        emb.position_embeddings.shape[1])

    enc = "transformer.encoder"
    yield f"{enc}.encoder_norm.weight", weights[
        "Transformer/encoder_norm/scale"]
    yield f"{enc}.encoder_norm.bias", weights["Transformer/encoder_norm/bias"]
    for i in range(len(model.transformer.encoder.layer)):
        src, dst = f"Transformer/encoderblock_{i}", f"{enc}.layer.{i}"
        mha = f"{src}/MultiHeadDotProductAttention_1"
        for name in ("query", "key", "value", "out"):
            kernel = np.asarray(weights[f"{mha}/{name}/kernel"])
            yield f"{dst}.attn.{name}.weight", kernel.reshape(hidden,
                                                              hidden).T
            yield f"{dst}.attn.{name}.bias", _flat(
                weights[f"{mha}/{name}/bias"])
        for fc, dense in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
            yield f"{dst}.ffn.{fc}.weight", np.asarray(
                weights[f"{src}/MlpBlock_3/{dense}/kernel"]).T
            yield f"{dst}.ffn.{fc}.bias", weights[
                f"{src}/MlpBlock_3/{dense}/bias"]
        for norm, ln in (("attention_norm", "LayerNorm_0"),
                         ("ffn_norm", "LayerNorm_2")):
            yield f"{dst}.{norm}.weight", weights[f"{src}/{ln}/scale"]
            yield f"{dst}.{norm}.bias", weights[f"{src}/{ln}/bias"]

    if not hasattr(emb, "hybrid_model"):
        return
    hm = f"{base}.hybrid_model"
    yield f"{hm}.root.conv.weight", _conv(weights["conv_root/kernel"])
    yield f"{hm}.root.gn.weight", _flat(weights["gn_root/scale"])
    yield f"{hm}.root.gn.bias", _flat(weights["gn_root/bias"])
    for block_name, block in emb.hybrid_model.body.named_children():
        for unit_name, unit in block.named_children():
            src = f"{block_name}/{unit_name}"
            dst = f"{hm}.body.{block_name}.{unit_name}"
            for n in ("1", "2", "3"):
                yield f"{dst}.conv{n}.weight", _conv(
                    weights[f"{src}/conv{n}/kernel"])
                yield f"{dst}.gn{n}.weight", _flat(
                    weights[f"{src}/gn{n}/scale"])
                yield f"{dst}.gn{n}.bias", _flat(weights[f"{src}/gn{n}/bias"])
            if hasattr(unit, "downsample"):
                yield f"{dst}.downsample.weight", _conv(
                    weights[f"{src}/conv_proj/kernel"])
                yield f"{dst}.gn_proj.weight", _flat(
                    weights[f"{src}/gn_proj/scale"])
                yield f"{dst}.gn_proj.bias", _flat(
                    weights[f"{src}/gn_proj/bias"])


def load_npz_into_model(model: nn.Module, weights) -> nn.Module:
    """Copy a Google ViT checkpoint (`np.load(path)`, or any mapping of its
    keys to arrays) into the `transformer` of a VisionTransformer or of a
    multi-head TransUnet, in place; returns the model. Raises KeyError for a
    key the checkpoint lacks and ValueError for a shape that does not fit."""
    state = model.state_dict()
    with torch.no_grad():
        for name, array in _entries(model, weights):
            target = state[name]
            array = np.asarray(array)
            if tuple(array.shape) != tuple(target.shape):
                raise ValueError(f"{name}: the checkpoint's {array.shape} "
                                 f"does not fit {tuple(target.shape)}")
            target.copy_(torch.from_numpy(np.array(array, np.float32)))
    return model


def synthetic_npz_weights(model: nn.Module, seed: int,
                          n_positions: int | None = None) -> dict:
    """A checkpoint in Google's key layout and shapes for `model`'s
    `transformer`, drawn from `seed`, for tests and for runs without the
    released file: kernels N(0, 1/fan_in), biases N(0, 0.02^2), norm scales
    1 + N(0, 0.1^2), position embeddings N(0, 0.02^2) of `n_positions`
    tokens (the model's count by default; one more carries a class token,
    another count a grid to re-grid)."""
    rng = np.random.RandomState(seed)
    sd = model.state_dict()
    emb = model.transformer.embeddings
    hidden = emb.position_embeddings.shape[-1]
    heads = model.transformer.encoder.layer[0].attn.num_heads
    d = hidden // heads

    def kernel(*shape, fan_in=None):
        fan_in = fan_in or int(np.prod(shape[:-1]))
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    def small(*shape):
        return (rng.randn(*shape) * 0.02).astype(np.float32)

    def scale(*shape):
        return (1.0 + rng.randn(*shape) * 0.1).astype(np.float32)

    def hwio(name):
        o, i, h, w = sd[name].shape
        return kernel(h, w, i, o)

    base = "transformer.embeddings"
    w = {"embedding/kernel": hwio(f"{base}.patch_embeddings.weight"),
         "embedding/bias": small(hidden),
         "Transformer/posembed_input/pos_embedding": small(
             1, n_positions or emb.position_embeddings.shape[1], hidden),
         "Transformer/encoder_norm/scale": scale(hidden),
         "Transformer/encoder_norm/bias": small(hidden)}
    mlp_dim = model.transformer.encoder.layer[0].ffn.fc1.out_features
    for i in range(len(model.transformer.encoder.layer)):
        root = f"Transformer/encoderblock_{i}"
        mha = f"{root}/MultiHeadDotProductAttention_1"
        for name in ("query", "key", "value"):
            w[f"{mha}/{name}/kernel"] = kernel(hidden, heads, d,
                                               fan_in=hidden)
            w[f"{mha}/{name}/bias"] = small(heads, d)
        w[f"{mha}/out/kernel"] = kernel(heads, d, hidden, fan_in=hidden)
        w[f"{mha}/out/bias"] = small(hidden)
        w[f"{root}/MlpBlock_3/Dense_0/kernel"] = kernel(hidden, mlp_dim)
        w[f"{root}/MlpBlock_3/Dense_0/bias"] = small(mlp_dim)
        w[f"{root}/MlpBlock_3/Dense_1/kernel"] = kernel(mlp_dim, hidden)
        w[f"{root}/MlpBlock_3/Dense_1/bias"] = small(hidden)
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            w[f"{root}/{ln}/scale"] = scale(hidden)
            w[f"{root}/{ln}/bias"] = small(hidden)
    if not hasattr(emb, "hybrid_model"):
        return w
    hm = f"{base}.hybrid_model"
    w["conv_root/kernel"] = hwio(f"{hm}.root.conv.weight")
    width = w["conv_root/kernel"].shape[-1]
    w["gn_root/scale"], w["gn_root/bias"] = scale(width), small(width)
    for block_name, block in emb.hybrid_model.body.named_children():
        for unit_name, unit in block.named_children():
            src = f"{block_name}/{unit_name}"
            dst = f"{hm}.body.{block_name}.{unit_name}"
            convs = ["conv1", "conv2", "conv3"]
            if hasattr(unit, "downsample"):
                convs.append("conv_proj")
            for conv in convs:
                port = "downsample" if conv == "conv_proj" else conv
                w[f"{src}/{conv}/kernel"] = hwio(f"{dst}.{port}.weight")
                gn = "gn_proj" if conv == "conv_proj" else f"gn{conv[-1]}"
                c = w[f"{src}/{conv}/kernel"].shape[-1]
                w[f"{src}/{gn}/scale"], w[f"{src}/{gn}/bias"] = (scale(c),
                                                                 small(c))
    return w
