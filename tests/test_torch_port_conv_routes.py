"""The fused conv's routes (unet_torch_tpu_torch/kernels/fused_conv.py) on
the CPU: `conv_route` as a function of (dtype, Cin, Cout) and on every conv
of the UNet-64, UNetMultitask-64 and TransUnet R50-ViT-B/16 eval forwards;
the wgmma route's tile plan covering every output value exactly once; and
the plain version against the JAX package's Pallas kernel (interpret mode)
and XLA reference at small shapes the wgmma and narrow routes take. The kernels
themselves are held against the plain version in
test_torch_port_kernel_cuda.py, on a card."""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet_torch_tpu.kernels import fused_conv as jax_fc
from unet_torch_tpu_torch.kernels import fused_conv as port_fc
from unet_torch_tpu_torch.models.transunet import vit
from unet_torch_tpu_torch.models.transunet.configs import CONFIGS
from unet_torch_tpu_torch.models.unet import build_model
from unet_torch_tpu_torch.nn import blocks


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads for the duration of each test of this file: the
    suite runs in several worker processes at once. The process's default
    comes back afterwards, for the tests that depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _expected_route(dtype, cin, cout):
    if dtype == torch.float32:
        return "reg"
    if cin % 64 == 0 and cout % 16 == 0:
        return "wgmma"
    if cin <= 16 and cout % 16 == 0 and cout <= 256:
        return "narrow"
    if cin % 8 == 0 and cout % 8 == 0:
        return "mma.sync"
    return "reg"


@pytest.mark.parametrize("cout", [8, 16, 24, 64, 136, 256, 272, 320])
@pytest.mark.parametrize("cin", [1, 3, 8, 16, 17, 24, 64, 192, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_route_is_a_function_of_dtype_and_channels(dtype, cin, cout):
    route = port_fc.conv_route(dtype, cin, cout)
    assert route == _expected_route(dtype, cin, cout)
    assert route in port_fc.ROUTES


def test_conv_route_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        port_fc.conv_route(torch.float16, 64, 64)


# (Cin, Cout) of each conv of the eval forwards, in order, at base 64: the
# UNet's inc, down1-4, up1-4 (two convs each); the two-head model's encoder
# (10), then each decoder's 8; the TransUnet decoder's conv_more and its
# four blocks (the first conv of each takes the ResNetV2 skip concatenated).
UNET_64 = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
           (256, 512), (512, 512), (512, 1024), (1024, 1024), (1024, 512),
           (512, 512), (512, 256), (256, 256), (256, 128), (128, 128),
           (128, 64), (64, 64)]
MULTITASK_64 = UNET_64[:10] + 2 * UNET_64[10:]
TRANSUNET = [(768, 512), (1024, 256), (256, 256), (512, 128), (128, 128),
             (192, 64), (64, 64), (64, 16), (16, 16)]


def _record_convs(monkeypatch, model, x):
    """(Cin, Cout) of each fused conv call of model's eval forward on x."""
    calls = []

    def record(h, w, scale, bias):
        calls.append((h.shape[-1], w.shape[-1]))
        return port_fc.fused_conv3x3_bn_relu_reference(h, w, scale, bias)

    monkeypatch.setattr(blocks, "fused_conv3x3_bn_relu", record)
    monkeypatch.setattr(vit, "fused_conv3x3_bn_relu", record)
    with torch.inference_mode():
        model.eval()(x)
    return calls


def _small_r50_b16(img):
    """R50-ViT-B/16 at its full widths (hidden 768, decoder (256, 128, 64,
    16), ResNetV2 width 64), one ViT layer and one unit a ResNet stage: the
    decoder's channel counts are those of the full model."""
    config = copy.deepcopy(CONFIGS["R50-ViT-B_16"])
    config.transformer.num_layers = 1
    config.resnet.num_layers = (1, 1, 1)
    config.n_classes = 3
    config.n_skip = 3
    config.patches.grid = (img // 16, img // 16)
    return vit.VisionTransformer(config, img, 3)


@pytest.mark.parametrize("name", ["unet", "multitask", "transunet"])
def test_main_path_convs_and_their_routes(monkeypatch, name):
    gen = torch.Generator().manual_seed(0)
    if name == "transunet":
        model, want, size = _small_r50_b16(32), TRANSUNET, 32
        # bf16: wgmma on all but the last conv (Cin 16), which takes the
        # narrow route
        routes = {"wgmma": 8, "narrow": 1, "mma.sync": 0, "reg": 0}
    else:
        kind = "single" if name == "unet" else "multi_task_reg"
        model = build_model(kind, n_channels=3, n_classes=3, base=64,
                            generator=gen)
        want = UNET_64 if name == "unet" else MULTITASK_64
        size = 16
        # bf16: wgmma on all but the first conv (Cin 3), which takes the
        # narrow route
        routes = {"wgmma": len(want) - 1, "narrow": 1, "mma.sync": 0,
                  "reg": 0}
    x = torch.from_numpy(
        np.random.RandomState(0).randn(1, size, size, 3).astype(np.float32))
    assert _record_convs(monkeypatch, model, x) == want
    got = dict.fromkeys(port_fc.ROUTES, 0)
    for cin, cout in want:
        got[port_fc.conv_route(torch.bfloat16, cin, cout)] += 1
    assert got == routes


# (B, H, W, Cout): the main path's 512x512 and 32x32 levels, odd H and W,
# W under the widest tile and not a multiple of its tile, a Cout that ends
# inside its last channel tile
PLAN_SHAPES = [(8, 512, 512, 64), (8, 32, 32, 1024), (2, 33, 17, 64),
               (1, 7, 70, 192), (3, 32, 32, 64), (1, 9, 20, 16),
               (2, 5, 1, 320), (1, 3, 130, 136)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_tile_plan_covers_every_output_value_once(shape):
    b, h, w, cout = shape
    plan = port_fc.conv_tile_plan(b, h, w, cout)
    assert plan.ht * plan.wt == port_fc.TILE_PIXELS
    assert plan.wt & (plan.wt - 1) == 0 and 1 <= plan.wt <= 64
    assert plan.ht % 2 == 0  # two consumer warpgroups of ht / 2 rows each
    assert plan.wt >= min(w, 64)
    assert plan.bn in (64, 128, 256) and plan.bn >= min(cout, 256)
    # the halo of a 2 x 64 tile, where its stages fit
    assert plan.halo == (plan.wt == 64 and plan.bn <= 128)
    covered = np.zeros((b, h, w, cout), np.int32)
    last = None
    for t in range(plan.tiles):
        ib, h0, w0, n0 = port_fc.conv_tile_origin(plan, t)
        # each tile starts inside one image and its channels
        assert 0 <= ib < b and 0 <= h0 < h and 0 <= w0 < w and 0 <= n0 < cout
        # channel tiles innermost: a pixel tile's channel tiles are neighbours
        if n0:
            assert last == (ib, h0, w0, n0 - plan.bn)
        last = (ib, h0, w0, n0)
        covered[ib, h0:h0 + plan.ht, w0:w0 + plan.wt, n0:n0 + plan.bn] += 1
    assert (covered == 1).all()


def test_tile_plan_of_the_main_path():
    """At 512x512 two image rows of 64 pixels, at 32x32 four rows of 32;
    Cout 1024 in 256-wide tiles: 64 pixel tiles x 4 = 256 tiles at batch 8.
    The halo is staged at the 512x512 and 256x256 levels."""
    plan = port_fc.conv_tile_plan(8, 512, 512, 64)
    assert plan[:3] == (2, 64, 64) and plan.halo
    plan = port_fc.conv_tile_plan(8, 256, 256, 128)
    assert plan[:3] == (2, 64, 128) and plan.halo
    assert not port_fc.conv_tile_plan(8, 128, 128, 256).halo
    plan = port_fc.conv_tile_plan(8, 32, 32, 1024)
    assert plan[:3] == (4, 32, 256) and plan.tiles == 256 and not plan.halo


# (B, H, W, Cin, Cout) the wgmma route takes, small; then the narrow
# route's: the UNet's Cin 3, the TransUnet tail's 16, one input channel
WGMMA_SHAPES = [(1, 6, 10, 64, 16), (2, 5, 9, 128, 64)]
NARROW_SHAPES = [(2, 7, 9, 3, 64), (1, 6, 10, 16, 16), (1, 5, 3, 1, 32)]


@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_reference_matches_pallas_and_xla_at_wgmma_shapes(shape):
    _reference_matches_pallas_and_xla(shape, "wgmma")


@pytest.mark.parametrize("shape", NARROW_SHAPES)
def test_reference_matches_pallas_and_xla_at_narrow_shapes(shape):
    _reference_matches_pallas_and_xla(shape, "narrow")


def _reference_matches_pallas_and_xla(shape, route):
    torch.backends.cudnn.allow_tf32 = False
    *xshape, cin, cout = shape
    assert port_fc.conv_route(torch.bfloat16, cin, cout) == route
    rng = np.random.RandomState(1)
    x = rng.randn(*xshape, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * (2.0 / (9 * cin)) ** 0.5).astype(
        np.float32)
    gamma, var = ((rng.rand(cout) + 0.5).astype(np.float32) for _ in range(2))
    beta, mean = ((rng.randn(cout) * 0.1).astype(np.float32)
                  for _ in range(2))
    scale, bias = (np.array(a) for a in
                   jax_fc.fold_bn(*(jnp.asarray(a)
                                    for a in (gamma, beta, mean, var))))
    args = (jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale),
            jnp.asarray(bias))
    pallas = jax_fc.fused_conv3x3_bn_relu_pallas(*args, th=4, interpret=True)
    xla = jax_fc.fused_conv3x3_bn_relu_reference(*args)
    ours = port_fc.fused_conv3x3_bn_relu_reference(
        torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(scale),
        torch.from_numpy(bias))
    assert ours.shape == tuple(xshape) + (cout,)
    # the bound of tests/test_fused_conv.py: f32 sums in another order
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(xla), atol=1e-4,
                               rtol=1e-4)


def test_launch_counts_reset_by_route():
    port_fc.fused_conv3x3_bn_relu.launches = 3
    port_fc.fused_conv3x3_bn_relu.launches_by_route["wgmma"] = 3
    port_fc.reset_launches()
    assert port_fc.fused_conv3x3_bn_relu.launches == 0
    assert port_fc.fused_conv3x3_bn_relu.launches_by_route == {
        "reg": 0, "mma.sync": 0, "wgmma": 0, "narrow": 0}
