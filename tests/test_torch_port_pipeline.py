"""Pipeline parallelism of the ViT encoder (parallel/pipeline.py,
core/dist.py's stage handoffs) on the CPU over gloo, against the JAX
package's `pipeline_blocks` and `pipelined_vit_forward` and against the
sequential block chain.

The ranks are this file run as a script,

    python tests/test_torch_port_pipeline.py <rank> <world> <port> <out>

(tests/test_torch_port_spatial.py's launcher), each importing torch and
the port alone. ViT width 16, 2 heads, MLP 32 (tests/test_pipeline.py's
config), S = 2 stages:

  * 4 layers, batch 8, M = 4, and 8 layers, batch 16, M = 8: the stages'
    output against JAX's `pipeline_blocks` and the port's sequential chain
    at 1e-5; the gradients of each stage's parameters of sum(out * out)
    against `jax.grad` of JAX's pipelined loss at 1e-4; the stage state
    gathered back, bit for bit the one-process state dict;
  * the VisionTransformer (32x32, 3 classes) eval forward with its encoder
    pipelined against JAX's `pipelined_vit_forward` at 1e-4;
  * (D, S) = (2, 2): one SGD step of the dry run's form (the eval-mode
    pipelined forward, `dice_bce_mc`, p - lr g) against JAX's.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_GRAD = dict(atol=1e-4, rtol=1e-4)
LR = 1e-2
# (layers, batch, microbatches) of the block cases
BLOCK_CASES = ((4, 8, 4), (8, 16, 8))
IMG, TOKENS = 32, 16


def port_config(num_layers):
    """tests/test_pipeline.py's `_wide_testing`, from the port's registry."""
    from unet_torch_tpu_torch.models.transunet.configs import CONFIGS

    cfg = copy.deepcopy(CONFIGS["testing"])
    cfg.hidden_size = 16
    cfg.transformer.num_heads = 2
    cfg.transformer.mlp_dim = 32
    cfg.transformer.num_layers = num_layers
    cfg.transformer.dropout_rate = 0.0
    return cfg


def port_model(state, num_layers):
    from unet_torch_tpu_torch.models.transunet.vit import VisionTransformer

    model = VisionTransformer(port_config(num_layers), IMG, 3)
    model.load_state_dict(state, strict=True)
    return model


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _block_case(spec, mesh, layers, batch, n_micro):
    """One BLOCK_CASES case on a rank: the output, the stage's gradients
    (by their one-process names) and the gathered state."""
    from unet_torch_tpu_torch.parallel.pipeline import (
        gather_stage_state,
        pipeline_blocks,
        stage_layers,
    )

    case = spec["blocks"][layers]
    model = port_model(case["state"], layers)
    full = {k: v.clone() for k, v in model.state_dict().items()}
    encoder = stage_layers(model.transformer.encoder, mesh)
    x = torch.from_numpy(case["x"])
    out = pipeline_blocks(mesh, encoder.layer, x, n_micro, torch.float32)
    (out * out).sum().backward()
    first = mesh.m * len(encoder.layer)
    grads = {f"{first + int(n.split('.', 1)[0])}.{n.split('.', 1)[1]}":
             p.grad.clone() for n, p in encoder.layer.named_parameters()}
    gathered = gather_stage_state(model, mesh)
    return {"out": out.detach(), "grads": grads,
            "round_trip": set(gathered) == set(full) and all(
                torch.equal(gathered[k], v) for k, v in full.items())}


def _broadcast_case(mesh):
    """broadcast_from's value and gradient on a rank: every rank computes
    sum(w * y) of its copy y of the last stage's x."""
    from unet_torch_tpu_torch.core.dist import broadcast_from

    x = torch.full((3,), float(mesh.m + 1), requires_grad=True)
    w = torch.tensor([1.0, 2.0, 3.0])
    y = broadcast_from(x, mesh.model - 1, mesh.model_group)
    (w * y).sum().backward()
    return {"y": y.detach(), "grad": x.grad}


def _train_case(case, mesh):
    """pipeline_blocks in train mode, dropout and attention dropout 0.1:
    the output and the input's gradient of sum(out * out)."""
    from unet_torch_tpu_torch.parallel.pipeline import (
        pipeline_blocks,
        stage_layers,
    )

    model = dropout_model(case["state"])
    encoder = stage_layers(model.transformer.encoder, mesh)
    x = torch.from_numpy(case["x"]).requires_grad_()
    out = pipeline_blocks(mesh, encoder.layer, x, 4, torch.float32,
                          train=True, seed=11)
    (out * out).sum().backward()
    return {"out": out.detach(), "dx": x.grad}


def dropout_model(state):
    """The 4-layer model with dropout and attention dropout 0.1."""
    from unet_torch_tpu_torch.models.transunet.vit import VisionTransformer

    cfg = port_config(4)
    cfg.transformer.dropout_rate = 0.1
    cfg.transformer.attention_dropout_rate = 0.1
    model = VisionTransformer(cfg, IMG, 3)
    model.load_state_dict(state, strict=True)
    return model


def _rank_case(spec):
    from unet_torch_tpu_torch.core.mesh import make_mesh
    from unet_torch_tpu_torch.parallel.pipeline import (
        make_pipeline_step,
        pipelined_vit_forward,
        stage_layers,
    )
    from unet_torch_tpu_torch.train.optim import make_optimizer

    mesh = make_mesh(*spec["mesh"], role="pipeline")
    result = {"rank": mesh.rank, "broadcast": _broadcast_case(mesh)}
    for layers, batch, n_micro in spec.get("block_cases", ()):
        result[layers] = _block_case(spec, mesh, layers, batch, n_micro)
    if "train" in spec:
        result["train"] = _train_case(spec["train"], mesh)
    if "vit" in spec:
        model = port_model(spec["vit"]["state"], 4).eval()
        stage_layers(model.transformer.encoder, mesh)
        with torch.no_grad():
            result["vit"] = pipelined_vit_forward(
                model, torch.from_numpy(spec["vit"]["x"]), mesh, 4)
    if "step" in spec:
        case = spec["step"]
        model = port_model(case["state"], 4)
        stage_layers(model.transformer.encoder, mesh)
        opt = make_optimizer("SGD", model.parameters(), LR)
        step = make_pipeline_step("dice_bce_mc", 3, mesh, 4)
        rows = mesh.rows(len(case["x"]))
        loss = step(model, opt, torch.from_numpy(case["x"][rows]),
                    torch.from_numpy(case["y"][rows]), LR)
        from unet_torch_tpu_torch.parallel.pipeline import gather_stage_state

        result["step"] = {"loss": float(loss),
                          "state": gather_stage_state(model, mesh)}
    return result


# --------------------------------------------------------------------------
# the pytest side
# --------------------------------------------------------------------------

def _jax_vit(num_layers, seed):
    """(flax VisionTransformer, its variables, the port's state dict)."""
    import jax
    import jax.numpy as jnp

    from unet_torch_tpu.models.transunet.vit import VisionTransformer
    from unet_torch_tpu_torch.ckpt.bridge import (
        transunet_state_dict_from_flax,
    )

    from test_pipeline import _wide_testing

    model = VisionTransformer(_wide_testing(num_layers), img_size=IMG,
                              num_classes=3)
    variables = model.init(jax.random.key(seed),
                           jnp.zeros((1, IMG, IMG, 3), jnp.float32),
                           train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return model, variables, transunet_state_dict_from_flax(
        variables["params"], variables["batch_stats"])


def _jax_blocks(num_layers, variables, x, n_micro):
    """JAX's pipelined block output and the gradient of sum(out * out)
    with respect to each block's parameters, over make_mesh(1, 2)."""
    import jax
    import jax.numpy as jnp

    from unet_torch_tpu.core.mesh import make_mesh
    from unet_torch_tpu.parallel.pipeline import (
        pipeline_blocks,
        stack_block_params,
        unstack_block_params,
        vit_encoder_block_fn,
    )

    from test_pipeline import _wide_testing

    mesh = make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    cfg = _wide_testing(num_layers)
    enc = variables["params"]["transformer"]["encoder"]
    stacked = stack_block_params(enc, num_layers)
    block_fn = vit_encoder_block_fn(cfg)

    def loss(st):
        out = pipeline_blocks(mesh, block_fn, st, jnp.asarray(x), n_micro)
        return jnp.sum(out * out), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
    return np.asarray(out), unstack_block_params(
        jax.tree_util.tree_map(np.asarray, g), num_layers)


def _jax_dryrun_step(variables, x, y, mesh):
    """__graft_entry__.py's dp x pp step: value_and_grad of dice_bce_mc on
    JAX's pipelined forward, then p - lr g."""
    import jax
    import jax.numpy as jnp

    from unet_torch_tpu.core.mesh import shard_batch
    from unet_torch_tpu.losses import calc_loss
    from unet_torch_tpu.parallel.pipeline import pipelined_vit_forward

    from test_pipeline import _wide_testing

    cfg = _wide_testing(4)

    def loss_fn(v, xb, yb):
        return calc_loss(pipelined_vit_forward(cfg, IMG, 3, v, xb, mesh,
                                               n_microbatches=4), yb,
                         loss_type="dice_bce_mc", num_classes=3)

    xb, yb = shard_batch(mesh, (jnp.asarray(x), jnp.asarray(y)))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables, xb, yb)
    params = jax.tree_util.tree_map(lambda p, g: np.asarray(p - LR * g),
                                    variables["params"], grads["params"])
    return float(loss), params


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    import jax

    from unet_torch_tpu.core.mesh import make_mesh
    from unet_torch_tpu.parallel.pipeline import pipelined_vit_forward
    from unet_torch_tpu_torch.ckpt.bridge import (
        transunet_state_dict_from_flax,
    )

    from test_pipeline import _wide_testing
    from test_torch_port_spatial import launch

    torch.set_num_threads(2)
    rng = np.random.RandomState(0)
    blocks, jax_side = {}, {}
    for layers, batch, n_micro in BLOCK_CASES:
        _, variables, state = _jax_vit(layers, layers)
        x = rng.randn(batch, TOKENS, 16).astype(np.float32)
        blocks[layers] = {"state": state, "x": x, "variables": variables}
        jax_side[layers] = _jax_blocks(layers, variables, x, n_micro)
    _, variables, state = _jax_vit(4, 1)
    x = rng.randn(8, IMG, IMG, 3).astype(np.float32)
    pmesh = make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    vit_ref = np.asarray(pipelined_vit_forward(
        _wide_testing(4), IMG, 3, variables, x, pmesh, n_microbatches=4))
    y = rng.randint(0, 3, x.shape[:3]).astype(np.float32)
    dpp = make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    step_ref = _jax_dryrun_step(variables, x, y, dpp)
    path = os.path.abspath(__file__)
    spec = {"mesh": (1, 2), "blocks": blocks, "block_cases": BLOCK_CASES,
            "vit": {"state": state, "x": x},
            "train": {"state": blocks[4]["state"], "x": blocks[4]["x"]}}
    runs = launch(path, spec, str(tmp_path_factory.mktemp("pipe12")))
    step_spec = {"mesh": (2, 2), "step": {"state": state, "x": x, "y": y}}
    step_runs = launch(path, step_spec, str(tmp_path_factory.mktemp(
        "pipe22")))
    return dict(runs=runs, jax=jax_side, blocks=blocks, vit_ref=vit_ref,
                step_runs=step_runs, step_ref=step_ref,
                step_before=state, step_after=transunet_state_dict_from_flax(
                    step_ref[1], variables["batch_stats"]))


def _peak_close(ours, ref, tol, name):
    from test_torch_port_parallel import _peak_close as close

    close(ours, ref, tol, name)


def _sequential(case, layers):
    """The port's one-process block chain, and its model."""
    model = port_model(case["state"], layers)
    h = torch.from_numpy(case["x"])
    for block in model.transformer.encoder.layer:
        h = block(h, torch.float32)
    return h, model


@pytest.mark.timeout(300)
@pytest.mark.parametrize("layers", [c[0] for c in BLOCK_CASES])
def test_pipeline_blocks_match_jax_and_the_sequential_chain(pipeline_runs,
                                                            layers):
    """Both stages hold the last stage's output; 2 or 4 layers a stage,
    M = 4 with S = 2 and M = 8."""
    ref, _ = _sequential(pipeline_runs["blocks"][layers], layers)
    for r in pipeline_runs["runs"]:
        out = r[layers]["out"].numpy()
        np.testing.assert_allclose(out, pipeline_runs["jax"][layers][0],
                                   **TOL)
        np.testing.assert_allclose(out, ref.detach().numpy(), **TOL)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("layers", [c[0] for c in BLOCK_CASES])
def test_pipeline_gradients_match_jax_grad(pipeline_runs, layers):
    """The backward walks the microbatches in reverse, each stage sending
    its inputs' gradients to the previous one; the output's gradient is the
    mean of the stages' copies: each stage parameter's gradient of
    sum(out * out) equals jax.grad of JAX's pipelined loss (and the
    one-process chain's). The bound is relative to each tensor's peak: the
    gradients reach 1e3, and f32 sums over 16 rows cancel in single
    elements near zero (4 ulps of the peak at 8 layers)."""
    from unet_torch_tpu_torch.ckpt.bridge import (
        transunet_state_dict_from_flax,
    )


    case = pipeline_runs["blocks"][layers]
    ref, model = _sequential(case, layers)
    (ref * ref).sum().backward()
    seq = {n: p.grad for n, p in
           model.transformer.encoder.layer.named_parameters()}
    # JAX's gradients by the port's names, through the bridge (linear in
    # each tensor) with the gradients in place of the blocks' parameters
    variables = case["variables"]
    tree = copy.deepcopy(variables["params"])
    tree["transformer"]["encoder"].update(pipeline_runs["jax"][layers][1])
    prefix = "transformer.encoder.layer."
    jax_grads = {k[len(prefix):]: v for k, v in transunet_state_dict_from_flax(
        tree, variables["batch_stats"]).items() if k.startswith(prefix)}
    seen = set()
    for r in pipeline_runs["runs"]:
        for name, g in r[layers]["grads"].items():
            _peak_close(g, jax_grads[name], TOL_GRAD, name)
            _peak_close(g, seq[name], TOL_GRAD, name)
            seen.add(name)
    assert seen == set(seq)


@pytest.mark.timeout(300)
def test_broadcast_from_hands_the_source_the_mean_gradient(pipeline_runs):
    """Each stage differentiates its copy of one loss: the last stage's x
    takes that loss's gradient once (not once a stage), the others zero."""
    for r in pipeline_runs["runs"]:
        assert torch.equal(r["broadcast"]["y"], torch.full((3,), 2.0))
        want = (torch.tensor([1.0, 2.0, 3.0]) if r["rank"] == 1
                else torch.zeros(3))
        assert torch.equal(r["broadcast"]["grad"], want)


@pytest.mark.timeout(300)
def test_train_mode_pipeline_draws_a_mask_a_layer_and_microbatch(
        pipeline_runs):
    """With train and dropout 0.1 each (layer, microbatch) draws from a
    generator seeded from the call's seed folded with both, by the layer's
    place in the whole encoder: the two stages give, to f32 rounding, what
    the one-process pipeline gives, and both differ from the eval output."""
    from unet_torch_tpu_torch.parallel.pipeline import pipeline_blocks

    case = pipeline_runs["blocks"][4]
    model = dropout_model(case["state"]).eval()
    x = torch.from_numpy(case["x"]).requires_grad_()
    out = pipeline_blocks(None, model.transformer.encoder.layer, x, 4,
                          torch.float32, train=True, seed=11)
    (out * out).sum().backward()
    # the blocks' eval mode restored
    assert not any(m.training for m in model.modules())
    for r in pipeline_runs["runs"]:
        np.testing.assert_allclose(r["train"]["out"].numpy(),
                                   out.detach().numpy(), **TOL)
        _peak_close(r["train"]["dx"], x.grad, TOL_GRAD, "dx")
        assert not np.allclose(r["train"]["out"].numpy(),
                               r[4]["out"].numpy(), atol=1e-3)


@pytest.mark.timeout(300)
def test_stage_state_round_trip_is_bit_exact(pipeline_runs):
    for r in pipeline_runs["runs"]:
        for layers, _, _ in BLOCK_CASES:
            assert r[layers]["round_trip"]


@pytest.mark.timeout(300)
def test_pipelined_vit_forward_matches_jax(pipeline_runs):
    """Embeddings, encoder norm, decoder and head replicated over the
    stages; the blocks through the pipeline; eval kernels (no_grad)."""
    for r in pipeline_runs["runs"]:
        np.testing.assert_allclose(r["vit"].numpy(),
                                   pipeline_runs["vit_ref"],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.timeout(300)
def test_dp_pp_sgd_step_matches_the_dry_run_step(pipeline_runs):
    """(D, S) = (2, 2): each data rank's rows in 4 microbatches of 2 rows
    (JAX: 4 of 4 over data 2), the Dice sums over the data group, the
    gradients averaged over the data group and the replicated ones over
    the stages; then SGD, p - lr g, as the dry run's step."""
    loss, _ = pipeline_runs["step_ref"]
    after, before = pipeline_runs["step_after"], pipeline_runs["step_before"]
    for r in pipeline_runs["step_runs"]:
        assert r["step"]["loss"] == pytest.approx(loss, rel=1e-5)
        state = r["step"]["state"]
        assert set(state) == set(after)
        for k, v in after.items():
            np.testing.assert_allclose(state[k].numpy(), v.numpy(),
                                       err_msg=k, atol=1e-5, rtol=1e-4)
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert any(".layer.3." in k for k in moved)


def test_stage_blocks_refuse_the_tensor_parallel_role():
    """A stage's blocks bound to a tensor-parallel mesh (model 2) would
    have their replicated inputs' gradients summed over the stages by
    Attention's copy_to_group: the pipeline refuses them, and tensor
    parallelism refuses a pipeline mesh."""
    from unet_torch_tpu_torch.core.mesh import Mesh
    from unet_torch_tpu_torch.nn.dropout import set_mesh
    from unet_torch_tpu_torch.parallel import parallelize
    from unet_torch_tpu_torch.parallel.pipeline import (
        pipeline_blocks,
        stage_layers,
    )

    model = port_model(port_model_state(2), 2)
    tensor = Mesh(data=1, model=2, rank=0, role="tensor")
    set_mesh(model, tensor)
    with pytest.raises(ValueError, match="tensor-parallel"):
        pipeline_blocks(None, model.transformer.encoder.layer,
                        torch.zeros(2, TOKENS, 16), 2, torch.float32)
    with pytest.raises(ValueError, match="tensor-parallel"):
        stage_layers(model.transformer.encoder,
                     Mesh(data=1, model=2, rank=0, role="pipeline"))
    with pytest.raises(ValueError, match="'tensor' role"):
        parallelize(port_model(port_model_state(2), 2),
                    Mesh(data=1, model=2, rank=0, role="pipeline"))


def port_model_state(num_layers):
    from unet_torch_tpu_torch.models.transunet.vit import VisionTransformer

    torch.manual_seed(0)
    return VisionTransformer(port_config(num_layers), IMG, 3).state_dict()


def test_pipeline_blocks_divisibility_errors():
    """The JAX function's three refusals, with its words."""
    from unet_torch_tpu_torch.core.mesh import Mesh
    from unet_torch_tpu_torch.parallel.pipeline import (
        pipeline_blocks,
        stage_layers,
    )

    model = port_model(port_model_state(3), 3)
    with pytest.raises(ValueError, match="3 layers not divisible into 2"):
        stage_layers(model.transformer.encoder,
                     Mesh(data=1, model=2, rank=0, role="pipeline"))
    layer = model.transformer.encoder.layer
    with pytest.raises(ValueError, match="batch 6 not divisible into 4"):
        pipeline_blocks(None, layer, torch.zeros(6, TOKENS, 16), 4,
                        torch.float32)
    with pytest.raises(ValueError, match="microbatch size 3 not divisible"):
        pipeline_blocks(Mesh(data=2, model=1, rank=0, role="pipeline"),
                        layer, torch.zeros(3, TOKENS, 16), 2, torch.float32)


def test_one_stage_pipeline_is_the_sequential_chain_and_keeps_modes():
    """S = 1 (no mesh): the microbatches through all blocks in one process,
    differentiable; the blocks' train modes restored."""
    from unet_torch_tpu_torch.parallel.pipeline import pipeline_blocks

    model = port_model(port_model_state(2), 2)
    layer = model.transformer.encoder.layer
    layer.train()
    x = torch.randn(4, TOKENS, 16, requires_grad=True)
    out = pipeline_blocks(None, layer, x, 2, torch.float32)
    ref = x
    for block in layer:
        ref = block(ref, torch.float32)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **TOL)
    assert all(b.training for b in layer)
    gx, = torch.autograd.grad(out.sum(), x)
    rx, = torch.autograd.grad(ref.sum(), x)
    np.testing.assert_allclose(gx.numpy(), rx.numpy(), **TOL)


if __name__ == "__main__":
    from test_torch_port_spatial import run_rank

    run_rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
             sys.argv[4], _rank_case)
