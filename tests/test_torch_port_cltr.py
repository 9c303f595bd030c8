"""The port's CLTR modules against the JAX package's, module by module and as
a whole, on the CPU: the same inputs, made from a seed with numpy, go
through the flax module and through the port's module loaded from the flax
trees by ckpt/bridge.py::cltr_state_dict_from_flax.

Sizes are those of tests/test_cltr.py (16 queries, hidden 32, 4 heads, one
encoder and two decoder layers, FFN 64, 64x64 images), with the full
ResNet-50 (3, 4, 6, 3). Forward tolerances: atol 2e-4 / rtol 1e-3 in f32
(sums in other orders through some sixty layers; observed about 1e-5), the
bound of tests/test_cltr_torch_parity.py. The criterion's functions are held
to 1e-6 (a handful of elementwise f32 operations)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_torch_tpu.models import cltr as jc
from unet_torch_tpu.models.cltr import box_ops as jbox
from unet_torch_tpu.models.cltr import segmentation as jseg
from unet_torch_tpu.models.cltr import transformer as jtr
from unet_torch_tpu_torch import ckpt
from unet_torch_tpu_torch.ckpt.bridge import (
    cltr_flax_from_state_dict,
    cltr_state_dict_from_flax,
    load_pretrained_resnet50,
)
from unet_torch_tpu_torch.models import cltr as pc
from unet_torch_tpu_torch.models.cltr import box_ops as pbox
from unet_torch_tpu_torch.models.cltr import segmentation as pseg
from unet_torch_tpu_torch.models.cltr import transformer as ptr
from unet_torch_tpu_torch.models.cltr.model import feature_mask
from unet_torch_tpu_torch.train.cltr_loop import (
    _bucket,
    cltr_collate,
    cltr_topk_count,
)

ATOL, RTOL = 2e-4, 1e-3
TINY = dict(num_queries=16, hidden_dim=32, nheads=4, enc_layers=1,
            dec_layers=2, dim_feedforward=64, dropout_rate=0.0)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _seed_frozen_bn(batch_stats, rng):
    """Non-trivial frozen-BN tensors (identity statistics would hide a
    swapped mean and bias); the last BN of each block small, so that sixteen
    residual sums stay O(1)."""
    def fill(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        n = leaf.shape[0]
        if keys[-1] == "running_var":
            return (rng.rand(n) + 0.5).astype(np.float32)
        if keys[-1] == "weight":
            last = keys[-2] in ("bn3", "downsample_bn")
            return ((rng.rand(n) + 0.5) * (0.3 if last else 1.0)).astype(
                np.float32)
        return (rng.randn(n) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, batch_stats)


@pytest.fixture(scope="module")
def tiny():
    """(flax model, variables as numpy, the port's model loaded from them)."""
    model = jc.ConditionalDETR(**TINY)
    x = jnp.zeros((1, 64, 64, 3))
    variables = _np_tree(model.init(jax.random.key(0), x, train=False))
    rng = np.random.RandomState(0)
    variables = {"params": variables["params"],
                 "batch_stats": _seed_frozen_bn(variables["batch_stats"],
                                                rng)}
    # the zero-initialised point head would hide its own wiring
    pe = variables["params"]["point_embed"]["layer2"]
    pe["kernel"] = (rng.randn(*pe["kernel"].shape) * 0.1).astype(np.float32)
    port = pc.ConditionalDETR(**TINY)
    port.load_state_dict(cltr_state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    return model, variables, port.eval()


def _close(ours, theirs, atol=ATOL, rtol=RTOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# position encodings, backbone
# ---------------------------------------------------------------------------

def test_sine_position_embedding_matches_jax():
    mask = np.zeros((2, 8, 6), bool)
    mask[0, 5:, :] = True
    mask[1, :, 4:] = True
    ours = pc.sine_position_embedding(torch.from_numpy(mask), 16)
    theirs = jc.sine_position_embedding(jnp.asarray(mask), 16)
    assert ours.shape == (2, 8, 6, 32)
    _close(ours, theirs, atol=1e-5, rtol=1e-5)


def test_gen_sineembed_for_position_matches_jax():
    pos = np.random.RandomState(1).rand(2, 7, 2).astype(np.float32)
    ours = pc.gen_sineembed_for_position(torch.from_numpy(pos), 32)
    theirs = jc.gen_sineembed_for_position(jnp.asarray(pos), 32)
    _close(ours, theirs, atol=1e-5, rtol=1e-5)


def test_learned_position_embedding_matches_jax():
    mod = jc.PositionEmbeddingLearned(8)
    x = jnp.zeros((2, 5, 7, 3))
    variables = _np_tree(mod.init(jax.random.key(1), x))
    ours = pc.PositionEmbeddingLearned(8)
    ours.load_state_dict({
        f"{name}.weight": torch.from_numpy(
            np.array(variables["params"][name]["embedding"]))
        for name in ("row_embed", "col_embed")})
    _close(ours(torch.zeros(2, 5, 7, 3)), mod.apply(variables, x), atol=0,
           rtol=0)


def test_backbone_features_match_jax(tiny):
    _, variables, port = tiny
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    theirs = jc.ResNet50(return_interm=True).apply(
        {"params": variables["params"]["backbone"],
         "batch_stats": variables["batch_stats"]["backbone"]},
        jnp.asarray(x))
    port.backbone.return_interm = True
    try:
        with torch.no_grad():
            ours = port.backbone(torch.from_numpy(x))
    finally:
        port.backbone.return_interm = False
    assert [tuple(o.shape) for o in ours] == [
        (2, 16, 16, 256), (2, 8, 8, 512), (2, 4, 4, 1024), (2, 2, 2, 2048)]
    for o, t in zip(ours, theirs):
        _close(o, t)


def test_backbone_freeze_mask_matches_jax(tiny):
    _, variables, port = tiny
    theirs = jc.backbone_freeze_mask(variables["params"]["backbone"])
    ours = pc.backbone_freeze_mask(port.backbone)
    frozen = sorted(k for k, v in ours.items() if not v)
    assert frozen == sorted(
        ["conv1.weight"] + [f"layer1.{b}.conv{i}.weight" for b in range(3)
                            for i in "123"] + ["layer1.0.downsample.0.weight"])
    # the JAX mask's test `k == "conv1"` also catches the first conv of
    # every bottleneck of layers 2-4 (4 + 6 + 3), which the reference does
    # not freeze; the port's mask is the reference's
    n_frozen_jax = sum(not v for v in jax.tree_util.tree_leaves(theirs))
    assert n_frozen_jax == len(frozen) + 13
    # neither package applies it: every backbone parameter takes gradients
    assert all(p.requires_grad for p in port.backbone.parameters())


def test_load_pretrained_resnet50_from_torchvision_layout(tiny):
    """A synthetic state_dict with torchvision's resnet50 names (and its
    classifier and BN counters) installs into the port's backbone, and gives
    the features the JAX loader gives from the same dict."""
    from unet_torch_tpu.ckpt.torch_import import load_torchvision_resnet50

    _, variables, _ = tiny
    rng = np.random.RandomState(3)
    port = pc.ConditionalDETR(**TINY).eval()
    sd = {}
    for k, v in port.backbone.state_dict().items():
        scale = 0.3 if (".bn3." in k or "downsample.1" in k) else 1.0
        if k.endswith("running_var") or k.endswith(".weight") and v.dim() == 1:
            sd[k] = ((rng.rand(*v.shape) + 0.5) * scale).astype(np.float32)
        else:
            sd[k] = (rng.randn(*v.shape) * (0.05 if v.dim() == 4 else 0.1)
                     ).astype(np.float32)
    full = {f"backbone.0.body.{k}": torch.from_numpy(v)
            for k, v in sd.items()}
    full["backbone.0.body.fc.weight"] = torch.zeros(1000, 2048)
    full["backbone.0.body.bn1.num_batches_tracked"] = torch.tensor(7)
    load_pretrained_resnet50(port, full, prefix="backbone.0.body.")
    for k, v in port.backbone.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    p, b = load_torchvision_resnet50(sd, variables["params"]["backbone"],
                                     variables["batch_stats"]["backbone"])
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        _close(port.backbone(torch.from_numpy(x)),
               jc.ResNet50().apply({"params": p, "batch_stats": b},
                                   jnp.asarray(x)))
    with pytest.raises(RuntimeError):  # strict: a missing tensor raises
        load_pretrained_resnet50(port, {k: v for k, v in sd.items()
                                        if k != "conv1.weight"})


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------

def _transformer_inputs(rng, b=2, h=3, w=4, c=32, q=6):
    src = rng.randn(b, h, w, c).astype(np.float32)
    pos = rng.randn(b, h, w, c).astype(np.float32)
    query = rng.randn(q, c).astype(np.float32)
    mask = np.zeros((b, h, w), bool)
    mask[1, :, 2:] = True
    return src, pos, query, mask


def test_encoder_and_decoder_layer_match_jax(tiny):
    _, variables, port = tiny
    tp = variables["params"]["transformer"]
    rng = np.random.RandomState(4)
    src, pos, query, mask = _transformer_inputs(rng)
    b = src.shape[0]
    tokens, pos_t = src.reshape(b, 12, 32), pos.reshape(b, 12, 32)
    mask_t = mask.reshape(b, 12)
    theirs = jtr.TransformerEncoderLayer(32, 4, 64, 0.0).apply(
        {"params": tp["encoder_layer0"]}, jnp.asarray(tokens),
        jnp.asarray(pos_t), train=False, key_padding_mask=jnp.asarray(mask_t))
    with torch.no_grad():
        ours = port.transformer.encoder.layers[0](
            torch.from_numpy(tokens), torch.from_numpy(pos_t),
            torch.from_numpy(mask_t))
    _close(ours, theirs)

    tgt = rng.randn(b, 6, 32).astype(np.float32)
    query_pos = np.broadcast_to(query[None], (b, 6, 32)).copy()
    sine = rng.randn(b, 6, 32).astype(np.float32)
    for i, first in ((0, True), (1, False)):
        theirs = jtr.TransformerDecoderLayer(
            32, 4, 64, 0.0, has_ca_qpos_proj=first).apply(
            {"params": tp[f"decoder_layer{i}"]}, jnp.asarray(tgt),
            jnp.asarray(tokens), jnp.asarray(pos_t), jnp.asarray(query_pos),
            jnp.asarray(sine), first, train=False,
            key_padding_mask=jnp.asarray(mask_t))
        with torch.no_grad():
            ours = port.transformer.decoder.layers[i](
                torch.from_numpy(tgt), torch.from_numpy(tokens),
                torch.from_numpy(pos_t), torch.from_numpy(query_pos),
                torch.from_numpy(sine), first, torch.from_numpy(mask_t))
        _close(ours, theirs)
    assert port.transformer.decoder.layers[1].ca_qpos_proj is None


@pytest.mark.parametrize("masked", [False, True])
def test_transformer_matches_jax(tiny, masked):
    _, variables, port = tiny
    rng = np.random.RandomState(5)
    src, pos, query, mask = _transformer_inputs(rng)
    if not masked:
        mask[:] = False
    theirs = jc.Transformer(32, 4, 1, 2, 64, 0.0, return_memory=True).apply(
        {"params": variables["params"]["transformer"]}, jnp.asarray(src),
        jnp.asarray(mask), jnp.asarray(query), jnp.asarray(pos), train=False)
    port.transformer.return_memory = True
    try:
        with torch.no_grad():
            ours = port.transformer(torch.from_numpy(src),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(query),
                                    torch.from_numpy(pos))
    finally:
        port.transformer.return_memory = False
    assert ours[0].shape == (2, 2, 6, 32) and ours[1].shape == (2, 6, 2)
    for o, t in zip(ours, theirs):
        _close(o, t)


def test_decoder_self_attention_dropout_matches_jax_kernel():
    """raw_attention at rate 0.1 with a given seed against JAX's
    `dropout_flash_attention` (its Pallas train kernel in interpret mode)
    with the same seed: the counter-hash mask is the same bit for bit, so
    the outputs agree to rounding (atol 1e-5: f32 sums in other orders) and
    the gradients too (atol 2e-4, the bound of the port's other gradient
    tests against jax.grad)."""
    from unet_torch_tpu.kernels import attention as jat

    rng = np.random.RandomState(6)
    b, nq, heads, hd = 2, 40, 4, 8
    q, k, v = (rng.randn(b, nq, heads * hd).astype(np.float32)
               for _ in range(3))
    g = rng.randn(b, nq, heads * hd).astype(np.float32)
    seed, rate = 1234567, 0.1

    def heads_first(x):
        return x.reshape(b, nq, heads, hd).transpose(0, 2, 1, 3)

    def theirs_fn(q, k, v):
        out = jat.dropout_flash_attention(
            heads_first(q), heads_first(k), heads_first(v),
            jnp.uint32(seed), hd ** -0.5, rate, interpret=True)
        return out.transpose(0, 2, 1, 3).reshape(b, nq, heads * hd)

    theirs, vjp = jax.vjp(theirs_fn, *(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    ours = ptr.raw_attention(tq, tk, tv, heads, dropout_rate=rate, seed=seed)
    _close(ours, theirs, atol=1e-5, rtol=1e-5)
    # dropout really ran: the rate-0 output differs
    plain = ptr.raw_attention(tq, tk, tv, heads)
    assert (plain - ours).abs().max() > 1e-2
    ours.backward(torch.from_numpy(g))
    for o, t in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(g))):
        _close(o, t, atol=2e-4, rtol=1e-3)


def test_train_attention_draws_seeds_from_the_bound_generator(tiny):
    """Every attention of a train-mode forward draws one seed from the host
    generator: the same generator state gives the same output, and a model
    without one raises."""
    port = pc.ConditionalDETR(**{**TINY, "dropout_rate": 0.1})
    from unet_torch_tpu_torch.nn.dropout import set_dropout_generator

    x = torch.from_numpy(
        np.random.RandomState(7).randn(1, 64, 64, 3).astype(np.float32))
    port.train()
    with pytest.raises(RuntimeError, match="seed generator"):
        port(x)
    outs = []
    for _ in range(2):
        set_dropout_generator(port, torch.Generator().manual_seed(3))
        ptr.set_attention_seed_generator(port,
                                         torch.Generator().manual_seed(4))
        outs.append(port(x)["pred_logits"])
    assert torch.equal(*outs)
    port.eval()
    with torch.no_grad():
        assert not torch.equal(port(x)["pred_logits"], outs[0])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _compare_outputs(ours, theirs):
    _close(ours["pred_logits"], theirs["pred_logits"])
    _close(ours["pred_points"], theirs["pred_points"])
    assert len(ours["aux_outputs"]) == len(theirs["aux_outputs"])
    for o, t in zip(ours["aux_outputs"], theirs["aux_outputs"]):
        _close(o["pred_logits"], t["pred_logits"])
        _close(o["pred_points"], t["pred_points"])


def test_conditional_detr_eval_forward_matches_jax(tiny):
    model, variables, port = tiny
    x = np.random.RandomState(8).randn(2, 64, 64, 3).astype(np.float32)
    theirs = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        ours = port(torch.from_numpy(x))
    assert ours["pred_logits"].shape == (2, 16, 2)
    assert ours["pred_points"].shape == (2, 16, 3)
    assert ours["pred_logits"].dtype == torch.float32
    _compare_outputs(ours, theirs)
    # the queries do differ from one another and from level to level
    assert ours["pred_points"].std(dim=1).max() > 1e-3


def test_conditional_detr_with_padding_mask_matches_jax(tiny):
    """A nested batch: the second image is padded on the right and below,
    so that its feature mask pads three of the four memory tokens."""
    model, variables, port = tiny
    x = np.random.RandomState(9).randn(2, 64, 64, 3).astype(np.float32)
    mask = np.zeros((2, 64, 64), bool)
    mask[1, 32:, :] = True
    mask[1, :, 32:] = True
    x[1][mask[1]] = 0.0
    theirs = model.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                         train=False)
    with torch.no_grad():
        ours = port(torch.from_numpy(x), torch.from_numpy(mask))
    _compare_outputs(ours, theirs)
    fm = feature_mask(torch.from_numpy(mask), 2, 2, 2, "cpu")
    assert fm.tolist() == [[[False, False], [False, False]],
                           [[False, True], [True, True]]]


def test_fully_padded_memory_gives_finite_outputs(tiny):
    """An image that is all padding: every key of its encoder and
    cross-attention rows is masked. The port's attention gives such a row
    the mean of its values (the JAX package's einsum path gives NaN), so the
    outputs stay finite, in eval and under autograd."""
    _, _, port = tiny
    x = torch.zeros(2, 64, 64, 3)
    mask = torch.zeros(2, 64, 64, dtype=torch.bool)
    mask[1] = True
    with torch.no_grad():
        out = port(x, mask)
    assert torch.isfinite(out["pred_logits"]).all()
    out = port(x, mask)
    out["pred_logits"].sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in port.parameters()
               if p.grad is not None)
    port.zero_grad()


def test_learned_position_model_matches_jax():
    kw = {**TINY, "position_embedding": "learned",
          "backbone_layers": (1, 1, 1, 1)}
    model = jc.ConditionalDETR(**kw)
    x = np.random.RandomState(10).randn(1, 64, 64, 3).astype(np.float32)
    variables = _np_tree(model.init(jax.random.key(2), jnp.asarray(x),
                                    train=False))
    port = pc.ConditionalDETR(**kw).eval()
    port.load_state_dict(cltr_state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    with torch.no_grad():
        _compare_outputs(port(torch.from_numpy(x)),
                         model.apply(variables, jnp.asarray(x), train=False))


def test_bf16_forward_is_close_to_jax_bf16(tiny):
    """Both packages in bf16 (parameters f32, products in bf16, f32 outputs).
    bf16 rounds at other places in the two frameworks: held to 0.1 on the
    logits (bf16 has 8 bits; some sixty layers) and 0.05 on the points in
    [0, 1]; both are 10x what f32 against bf16 differs by within JAX."""
    _, variables, port = tiny
    model = jc.ConditionalDETR(**TINY, dtype=jnp.bfloat16)
    x = np.random.RandomState(11).randn(2, 64, 64, 3).astype(np.float32)
    theirs = model.apply(variables, jnp.asarray(x), train=False)
    port.dtype = torch.bfloat16
    try:
        with torch.no_grad():
            ours = port(torch.from_numpy(x))
    finally:
        port.dtype = torch.float32
    assert ours["pred_logits"].dtype == torch.float32
    assert theirs["pred_logits"].dtype == jnp.float32
    _close(ours["pred_logits"], theirs["pred_logits"], atol=0.1, rtol=0)
    _close(ours["pred_points"], theirs["pred_points"], atol=0.05, rtol=0)


def test_build_cltr_contract():
    model, criterion, post = pc.build_cltr(
        {"num_queries": 8, "hidden_dim": 32, "nheads": 4, "enc_layers": 1,
         "dec_layers": 3, "dim_feedforward": 64, "precision": "bf16",
         "backbone_layers": [1, 1, 1, 1], "set_cost_point": 4},
        torch.Generator().manual_seed(0))
    assert model.dtype == torch.bfloat16 and model.dec_layers == 3
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert criterion.cost_point == 4
    assert set(criterion.weight_dict) == {
        "loss_ce", "loss_point", "loss_ce_0", "loss_point_0", "loss_ce_1",
        "loss_point_1"}
    assert isinstance(post["point"], pc.PostProcess)
    # the focal prior, the zeroed point head, N(0, 1) queries
    assert torch.allclose(model.class_embed.bias,
                          torch.full((2,), -4.59512), atol=1e-4)
    assert not model.point_embed.layers[-1].weight.any()
    assert 0.8 < model.query_embed.weight.std() < 1.2
    # the same generator state draws the same weights
    again = pc.build_cltr({"num_queries": 8, "hidden_dim": 32, "nheads": 4,
                           "enc_layers": 1, "dec_layers": 3,
                           "dim_feedforward": 64,
                           "backbone_layers": [1, 1, 1, 1]},
                          torch.Generator().manual_seed(0))[0]
    assert torch.equal(again.transformer.decoder.layers[2].linear1.weight,
                       model.transformer.decoder.layers[2].linear1.weight)


def test_full_width_model_builds_without_not_implemented():
    """configs/cltr.yml's model at full width: 2000 queries, hidden 256,
    6 + 6 layers (built, not run: the forward is the card's work)."""
    from unet_torch_tpu_torch.cli.config import Config
    from unet_torch_tpu_torch.core import not_ported

    cfg = Config.load("configs/cltr.yml")
    assert "CLTR" not in not_ported.MODEL_TYPES
    model, _, _ = pc.build_cltr(dict(cfg.raw["cltr_config"]))
    assert model.query_embed.weight.shape == (2000, 256)
    assert len(model.transformer.encoder.layers) == 6
    assert len(model.transformer.decoder.layers) == 6
    n = sum(p.numel() for p in model.parameters())
    assert 40e6 < n < 50e6


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

def test_bridge_round_trip_is_exact(tiny):
    _, variables, port = tiny
    sd = cltr_state_dict_from_flax(variables["params"],
                                   variables["batch_stats"])
    assert set(sd) == set(port.state_dict())
    params, stats = cltr_flax_from_state_dict(sd, variables["params"],
                                              variables["batch_stats"])
    flat_a = jax.tree_util.tree_leaves_with_path(
        {"p": variables["params"], "b": variables["batch_stats"]})
    flat_b = jax.tree_util.tree_leaves_with_path({"p": params, "b": stats})
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # the payload dispatch picks the CLTR bridge
    sd2 = ckpt.state_dict_from_jax_payload(variables)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    # frozen-BN tensors are buffers, not parameters
    names = {n for n, _ in port.named_parameters()}
    assert "backbone.bn1.weight" not in names
    assert "backbone.bn1.weight" in dict(port.named_buffers())


# ---------------------------------------------------------------------------
# criterion, postprocess, counting
# ---------------------------------------------------------------------------

def _targets(rng, counts, t=8):
    targets = []
    for n in counts:
        pts = rng.rand(n, 3).astype(np.float32)
        targets.append({"labels": np.ones(n, np.int64), "points": pts,
                        "points_macher": pts})
    return targets


def _criterion_inputs(rng, b=3, q=16, t=8, levels=3):
    def level():
        return {"pred_logits": rng.randn(b, q, 2).astype(np.float32) - 2,
                "pred_points": rng.rand(b, q, 3).astype(np.float32)}

    out = level()
    out["aux_outputs"] = [level() for _ in range(levels - 1)]
    targets = _targets(rng, [5, 0, 8][:b])
    return out, targets


def _both(out, fn):
    return (jax.tree_util.tree_map(jnp.asarray, out),
            jax.tree_util.tree_map(torch.from_numpy, out))


def test_pad_targets_matches_jax():
    rng = np.random.RandomState(12)
    targets = _targets(rng, [3, 0, 11])
    ours = pc.pad_targets(targets, 8, 3)
    theirs = jc.pad_targets(targets, 8, 3)
    for o, t in zip(ours, theirs):
        assert o.dtype == t.dtype
        np.testing.assert_array_equal(o, t)


def test_cost_matrix_hungarian_and_losses_match_jax():
    rng = np.random.RandomState(13)
    out, targets = _criterion_inputs(rng)
    labels, points, mpoints, valid = pc.pad_targets(targets, 8, 3)
    jout, tout = _both(out, None)
    weights = pc.build_weight_dict(dec_layers=3)
    assert weights == jc.build_weight_dict(dec_layers=3)
    jcrit = jc.SetCriterion(num_classes=2, weight_dict=weights)
    pcrit = pc.SetCriterion(num_classes=2, weight_dict=weights)
    tl, tp, tv = (torch.from_numpy(a) for a in (labels, points, valid))
    jl, jp, jv = (jnp.asarray(a) for a in (labels, points, valid))

    theirs = np.asarray(jcrit.all_cost_matrices(jout, jl, jp, jv))
    ours = pcrit.all_cost_matrices(tout, tl, tp, tv)
    assert ours.shape == (3, 3, 16, 8)
    _close(ours, theirs, atol=1e-6, rtol=1e-6)
    assert (ours[:, 1] == 1e9).all()  # the image without targets

    match = pcrit.hungarian(ours.numpy(), valid.sum(1))
    np.testing.assert_array_equal(
        match, jcrit.hungarian(theirs, valid.sum(1)))

    total_t, dict_t = jcrit.losses(jout, jl, jp, jv, jnp.asarray(match))
    total_o, dict_o = pcrit.losses(tout, tl, tp, tv,
                                   torch.from_numpy(match))
    assert set(dict_o) == set(dict_t)
    for k in dict_t:
        _close(dict_o[k], dict_t[k], atol=1e-6, rtol=1e-6)
    _close(total_o, total_t, atol=1e-5, rtol=1e-6)


def test_level_losses_query_zero_repair():
    """Padded slots all carry query 0. Without a valid target on query 0 it
    must stay background: as the JAX package's repaired scatter gives it.
    With a valid target on query 0 its class must survive; the JAX scatter
    then has duplicate indices and on the CPU its last write, a padded
    slot's, wins (ROADMAP.md queue 3), so there the port is held against
    the JAX losses of the same targets without padding."""
    rng = np.random.RandomState(14)
    logits = rng.randn(1, 6, 2).astype(np.float32)
    points = rng.rand(1, 6, 3).astype(np.float32)
    labels = np.ones((1, 4), np.int32)
    tgt = rng.rand(1, 4, 3).astype(np.float32)
    valid = np.array([[True, True, False, False]])
    jcrit, pcrit = jc.SetCriterion(), pc.SetCriterion()

    def both(match, n=4):
        args = (logits, points, labels[:, :n], tgt[:, :n], valid[:, :n],
                np.asarray(match, np.int32)[:, :n])
        theirs = jcrit.level_losses(*(jnp.asarray(a) for a in args), 2.0)
        ours = pcrit.level_losses(*(torch.from_numpy(a) for a in args), 2.0)
        return ours, theirs

    ours, theirs = both([[3, 2, 0, 0]])  # no valid target on query 0
    for k in theirs:
        _close(ours[k], theirs[k], atol=1e-6, rtol=1e-6)
    ours, theirs_padded = both([[3, 0, 0, 0]])  # a valid target on query 0
    _, theirs = both([[3, 0, 0, 0]], n=2)  # the same targets, no padding
    for k in ("loss_ce", "loss_point"):
        _close(ours[k], theirs[k], atol=1e-6, rtol=1e-6)
    assert abs(float(theirs_padded["loss_ce"]) - float(theirs["loss_ce"])) \
        > 1e-3
    # where the padded slots point changes nothing in the port
    again = pcrit.level_losses(*(torch.from_numpy(a) for a in (
        logits, points, labels, tgt, valid,
        np.array([[3, 0, 5, 1]], np.int32))), 2.0)
    assert torch.equal(again["loss_ce"], ours["loss_ce"])


def test_focal_and_dice_losses_match_jax():
    from unet_torch_tpu.models.cltr.criterion import dice_loss as jdice
    from unet_torch_tpu_torch.models.cltr.criterion import dice_loss as pdice

    rng = np.random.RandomState(15)
    x = rng.randn(3, 10, 2).astype(np.float32) * 3
    t = (rng.rand(3, 10, 2) > 0.7).astype(np.float32)
    for alpha in (0.25, -1.0):
        _close(pc.sigmoid_focal_loss(torch.from_numpy(x),
                                     torch.from_numpy(t), 4.0, alpha),
               jc.sigmoid_focal_loss(jnp.asarray(x), jnp.asarray(t), 4.0,
                                     alpha), atol=1e-6, rtol=1e-6)
    _close(pdice(torch.from_numpy(x), torch.from_numpy(t), 4.0),
           jdice(jnp.asarray(x), jnp.asarray(t), 4.0), atol=1e-6, rtol=1e-6)


def test_postprocess_and_topk_count_match_jax():
    from unet_torch_tpu.train.cltr_loop import (
        cltr_topk_count as jax_topk_count,
    )

    rng = np.random.RandomState(16)
    logits = rng.randn(2, 300, 2).astype(np.float32)
    points = rng.rand(2, 300, 3).astype(np.float32)
    sizes = np.array([[256, 256], [768, 512]], np.float32)
    theirs = jc.PostProcess()({"pred_logits": logits, "pred_points": points},
                              sizes)
    ours = pc.PostProcess()({"pred_logits": torch.from_numpy(logits),
                             "pred_points": torch.from_numpy(points)}, sizes)
    for o, t in zip(ours, theirs):
        for key in ("scores", "labels", "points"):
            np.testing.assert_allclose(o[key], t[key], atol=1e-6, rtol=0)
    for thr in (0.35, 0.6):
        assert cltr_topk_count(logits, thr) == jax_topk_count(logits, thr)
    assert _bucket(0) == 32 and _bucket(33) == 64 and _bucket(64) == 64
    imgs, targets = cltr_collate([([np.zeros((4, 4, 3))], [{"a": 1}]),
                                  ([np.ones((4, 4, 3))], [{"a": 2}])])
    assert imgs.shape == (2, 4, 4, 3) and [t["a"] for t in targets] == [1, 2]


def test_inverse_sigmoid_matches_jax():
    x = np.array([0.0, 1e-7, 0.3, 0.5, 1.0, 1.2, -0.1], np.float32)
    _close(pc.inverse_sigmoid(torch.from_numpy(x)),
           jc.inverse_sigmoid(jnp.asarray(x)), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# off the main path: box_ops, segmentation
# ---------------------------------------------------------------------------

def test_box_ops_match_jax():
    rng = np.random.RandomState(17)
    c = rng.rand(5, 4).astype(np.float32) + 0.1
    a = np.asarray(jbox.box_cxcywh_to_xyxy(jnp.asarray(c)))
    _close(pbox.box_cxcywh_to_xyxy(torch.from_numpy(c)), a, 1e-6, 1e-6)
    _close(pbox.box_xyxy_to_cxcywh(torch.from_numpy(a)),
           jbox.box_xyxy_to_cxcywh(jnp.asarray(a)), 1e-6, 1e-6)
    b = np.asarray(jbox.box_cxcywh_to_xyxy(
        jnp.asarray(rng.rand(3, 4).astype(np.float32) + 0.1)))
    for ours, theirs in zip(
            pbox.box_iou(torch.from_numpy(a), torch.from_numpy(b)),
            jbox.box_iou(jnp.asarray(a), jnp.asarray(b))):
        _close(ours, theirs, 1e-6, 1e-6)
    _close(pbox.generalized_box_iou(torch.from_numpy(a), torch.from_numpy(b)),
           jbox.generalized_box_iou(jnp.asarray(a), jnp.asarray(b)),
           1e-6, 1e-6)
    masks = rng.rand(3, 9, 7) > 0.7
    masks[1] = False
    np.testing.assert_array_equal(pbox.masks_to_boxes(masks),
                                  jbox.masks_to_boxes(masks))
    assert pbox.masks_to_boxes(np.zeros((0, 4, 4))).shape == (0, 4)


def test_detrsegm_forward_matches_jax():
    kw = dict(num_queries=4, hidden_dim=32, nheads=4, enc_layers=1,
              dec_layers=2, dim_feedforward=64, dropout_rate=0.0)
    model = jseg.DETRsegm(**kw)
    rng = np.random.RandomState(18)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    variables = _np_tree(model.init(jax.random.key(3), jnp.asarray(x),
                                    train=False))
    variables = {"params": variables["params"],
                 "batch_stats": _seed_frozen_bn(variables["batch_stats"],
                                                rng)}
    port = pseg.DETRsegm(**kw).eval()
    port.load_state_dict(cltr_state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    mask = np.zeros((1, 64, 64), bool)
    mask[0, :, 32:] = True
    theirs = model.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                         train=False)
    with torch.no_grad():
        ours = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert ours["pred_masks"].shape == (1, 4, 16, 16)
    for key in ("pred_logits", "pred_points", "pred_masks"):
        _close(ours[key], theirs[key])


def test_segm_postprocessors_match_jax():
    rng = np.random.RandomState(19)
    outputs = {"pred_logits": rng.randn(2, 5, 3).astype(np.float32) * 4,
               "pred_masks": rng.randn(2, 5, 8, 8).astype(np.float32) * 3}
    sizes, orig = [(24, 20), (32, 32)], [(30, 25), (16, 16)]
    theirs = jseg.postprocess_segm([{}, {}], outputs, orig, sizes)
    ours = pseg.postprocess_segm(
        [{}, {}], {k: torch.from_numpy(v) for k, v in outputs.items()}, orig,
        sizes)
    for o, t in zip(ours, theirs):
        assert o["masks"].shape == t["masks"].shape
        # a pixel whose resized logit sits on the threshold may flip
        assert (o["masks"] != t["masks"]).mean() < 1e-3
    theirs = jseg.postprocess_panoptic(outputs, sizes, orig, threshold=0.5)
    ours = pseg.postprocess_panoptic(
        {k: torch.from_numpy(v) for k, v in outputs.items()}, sizes, orig,
        threshold=0.5)
    assert [o["segments_info"] for o in ours] == [
        t["segments_info"] for t in theirs]
    assert [o["png_string"] for o in ours] == [t["png_string"] for t in theirs]
