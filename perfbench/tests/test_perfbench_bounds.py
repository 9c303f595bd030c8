"""The frozen bounds against the port's table of kernels (PERF.md): 3.06 ms
for UNet-64's 18 fused convs, 0.75 ms for the TransUnet decoder's 9, 0.31
and 0.78 ms for the ViT's 12 attention forwards and backwards, batch 8 at
512x512. The shapes come from the references' recorded calls."""

import pytest

from perfbench.core import flops, peaks, spec


def _records(config, train=False):
    c = spec.cell(f"{config}.eval")
    return flops.count(c["config_spec"], train)[1]


def test_unet_fused_convs():
    shapes = [s for k, s in _records("unet64_mc") if k == "conv_bn_relu"]
    assert len(shapes) == 18
    ms = peaks.conv_bound(shapes, 8)[0] * 1e3
    assert ms == pytest.approx(3.06, abs=0.005)


def test_transunet_decoder_fused_convs():
    shapes = [s for k, s in _records("transunet_r50_b16")
              if k == "conv_bn_relu"]
    assert len(shapes) == 9
    assert peaks.conv_bound(shapes, 8)[0] * 1e3 == pytest.approx(0.75,
                                                                abs=0.005)


def test_vit_attention():
    calls = [s for k, s in _records("transunet_r50_b16") if k == "attention"]
    assert calls == [(1, 12, 1024, 1024, 64, 64)] * 12
    shape = (8,) + calls[0][1:]
    fwd = 12 * peaks.attention_bound(shape)[0] * 1e3
    bwd = 12 * peaks.attention_bound(shape, backward=True)[0] * 1e3
    assert fwd == pytest.approx(0.31, abs=0.005)
    assert bwd == pytest.approx(0.78, abs=0.005)
