"""make_predict_fn's CUDA graphs on a card: each batch key captured once and
replayed after, every result bit for bit the eager forward's and
postprocess's, read in the one-deep order of eval/reports.py::_batched_eval
(a batch's result after the next batch's call), so that a returned graph
buffer would show as the next batch's map. Skips without a card.

This file imports no JAX, so that it runs where only the port is installed:

    python -m pytest tests/test_torch_port_predict_graph_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from unet_torch_tpu_torch.eval import reports
from unet_torch_tpu_torch.eval.metrics import class_argmax
from unet_torch_tpu_torch.kernels import attention as port_attn
from unet_torch_tpu_torch.kernels import fused_conv as port_fc
from unet_torch_tpu_torch.models.transunet.vit import build_transunet
from unet_torch_tpu_torch.models.unet import build_model
from unet_torch_tpu_torch.utils import debug

BATCHES = 5  # distinct batches of the first key


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs have no CPU mode")


def _seeded(model, gen):
    """Seeded BatchNorm statistics and affine, so that eval's folded BN
    is not the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return model


def _model(name, gen):
    if name == "unet64_classes":
        return build_model("single", n_channels=3, n_classes=3, base=64,
                           generator=gen)
    if name == "unet_binary":
        return build_model("single", n_channels=3, n_classes=1, base=32,
                           generator=gen)
    if name == "unet_multitask":
        return build_model("multi_task", n_channels=3, n_classes=1, base=32,
                           generator=gen)
    return build_transunet("TransUnet", img_size=512, num_classes=3,
                           generator=gen)


# (model, predict's flags, batch, size): UNet-64 as the flagship serves
# it, a binary UNet (test_single), a two-headed multitask UNet (logits,
# test_multiple_reg) and TransUnet R50-ViT-B/16 at batch 8 of 512x512
CASES = [("unet64_classes", {"classes": True}, 8, 512),
         ("unet_binary", {"binary": True}, 8, 256),
         ("unet_multitask", {}, 4, 256),
         ("transunet_r50_b16", {"classes": True}, 8, 512)]


def _eager(model, xs, classes=False, binary=False, device="cuda"):
    """The eager forward and postprocess, as make_predict_fn ran them
    before its graphs: the batch copied and cast as `.to` does, on the
    host's result as numpy."""
    with torch.inference_mode(), torch.cuda.device(device):
        x = torch.from_numpy(xs).to(device=device, dtype=torch.bfloat16,
                                    non_blocking=True)
        out = model(x)
        if classes:
            out = class_argmax(out)
        elif binary:
            out = reports.sigmoid_mask(out)
        return _host(out)


def _host(out):
    if isinstance(out, tuple):
        return tuple(_host(o) for o in out)
    return (out.float() if out.is_floating_point() else out).cpu().numpy()


def _equal(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _launches():
    return (port_fc.fused_conv3x3_bn_relu.launches,
            port_attn.fused_attention.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("name,flags,batch,size", CASES,
                         ids=[c[0] for c in CASES])
def test_replays_equal_the_eager_forward_bit_for_bit(name, flags, batch,
                                                     size):
    _needs_card()
    gen = torch.Generator().manual_seed(22)
    model = _seeded(_model(name, gen), gen).cuda().eval()
    rng = np.random.RandomState(22)
    first = [rng.randn(batch, size, size, 3).astype(np.float32)
             for _ in range(BATCHES)]
    second = [rng.randn(batch // 2, size, size, 3).astype(np.float32)
              for _ in range(2)]
    want = [_eager(model, xs, **flags) for xs in first + second]

    debug.reset_tally()
    predict = reports.make_predict_fn(model, "cuda", torch.bfloat16, **flags)
    got, prev, after_capture = [], None, None
    for k, xs in enumerate(first + second):
        out = predict(xs)
        if k == 0:
            after_capture = _launches()
        elif k < BATCHES:
            # the kernels' counters are Python's: a replay adds nothing
            assert _launches() == after_capture, k
        if prev is not None:
            got.append(_host(prev))
        prev = out
    got.append(_host(prev))
    torch.cuda.synchronize()

    for k, (g, w) in enumerate(zip(got, want)):
        assert _equal(g, w), f"{name}: batch {k} differs from the eager one"
    calls = len(first) + len(second)
    counts = {span: len(c) for span, c in debug.tally().items()}
    assert counts == {"predict.h2d": calls, "predict.forward": calls,
                      "predict.capture": 2, "predict.replay": calls - 2}


@pytest.mark.cuda
def test_the_first_call_warms_up_and_captures_each_kernel_launch():
    """UNet-64's 18 fused convs: GRAPH_WARMUP eager forwards and the
    capture, each through the wrapper."""
    _needs_card()
    gen = torch.Generator().manual_seed(23)
    model = _model("unet64_classes", gen).cuda().eval()
    predict = reports.make_predict_fn(model, "cuda", torch.bfloat16,
                                      classes=True)
    xs = np.random.RandomState(23).randn(2, 128, 128, 3).astype(np.float32)
    port_fc.reset_launches()
    predict(xs)
    assert port_fc.fused_conv3x3_bn_relu.launches == \
        18 * (reports.GRAPH_WARMUP + 1)
    predict(xs)
    torch.cuda.synchronize()
    assert port_fc.fused_conv3x3_bn_relu.launches == \
        18 * (reports.GRAPH_WARMUP + 1)


@pytest.mark.cuda
def test_an_in_place_weight_update_is_seen_on_replay():
    _needs_card()
    gen = torch.Generator().manual_seed(24)
    model = _seeded(_model("unet_binary", gen), gen).cuda().eval()
    xs = np.random.RandomState(24).randn(2, 64, 64, 3).astype(np.float32)
    predict = reports.make_predict_fn(model, "cuda", torch.bfloat16)
    before = _host(predict(xs))
    with torch.no_grad():
        model.outc.conv.weight.mul_(-1.0)
        model.outc.conv.bias.mul_(-1.0)
    after = _host(predict(xs))
    assert _equal(after, _eager(model, xs))
    assert not _equal(after, before)


class _Synchronising(torch.nn.Module):
    """A forward that reads a device value on the host: it runs eagerly
    and cannot be captured."""

    def forward(self, x):
        return x * float(x.float().abs().max())


@pytest.mark.cuda
def test_a_forward_that_cannot_be_captured_raises_with_its_name_and_key():
    _needs_card()
    predict = reports.make_predict_fn(_Synchronising(), "cuda",
                                      torch.float32)
    xs = np.ones((2, 8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match=r"_Synchronising.*\(2, 8, 8, 3\)"):
        predict(xs)


@pytest.mark.cuda
def test_a_forward_without_device_work_raises_as_an_empty_graph():
    """An identity forward in the batch's own dtype launches nothing: its
    capture is empty, as a capture on the wrong card would be."""
    _needs_card()
    predict = reports.make_predict_fn(torch.nn.Identity(), "cuda",
                                      torch.float32)
    xs = np.ones((2, 8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match=r"Identity.*empty CUDA graph"):
        predict(xs)


@pytest.mark.cuda
def test_a_card_other_than_the_current_one_is_served_by_replay():
    """test_cli --device cuda:1 moves the model there and leaves card 0
    current: each distinct batch's result, read one-deep, is that batch's
    eager one, and the current card stays card 0."""
    _needs_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    torch.cuda.set_device(0)
    gen = torch.Generator().manual_seed(25)
    model = _seeded(_model("unet_binary", gen), gen).to("cuda:1").eval()
    rng = np.random.RandomState(25)
    batches = [rng.randn(4, 128, 128, 3).astype(np.float32)
               for _ in range(BATCHES)]
    want = [_eager(model, xs, binary=True, device="cuda:1")
            for xs in batches]
    debug.reset_tally()
    predict = reports.make_predict_fn(model, "cuda:1", torch.bfloat16,
                                      binary=True)
    got, prev = [], None
    for xs in batches:
        out = predict(xs)
        assert out.device == torch.device("cuda:1")
        if prev is not None:
            got.append(_host(prev))
        prev = out
    got.append(_host(prev))
    assert torch.cuda.current_device() == 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert _equal(g, w), f"batch {k} differs from the eager one"
    assert not _equal(want[0], want[1])
    counts = {span: len(c) for span, c in debug.tally().items()}
    assert counts["predict.capture"] == 1
    assert counts["predict.replay"] == BATCHES - 1
