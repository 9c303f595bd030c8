"""Each reference's FLOP count (torch's FlopCounterMode on the meta device)
against a count by hand from its layer shapes: 2 operations a
multiply-add, a k x k conv 2 k^2 Cin Cout a output pixel, a stride-2
transposed 2x2 conv 2 * 4 Cin Cout an input pixel, a linear layer 2 Din
Dout a token."""

import pytest

from perfbench.core import flops, spec


def conv(k, cin, cout, h):
    return 2 * k * k * cin * cout * h * h


def unet64_forward():
    total = conv(3, 3, 64, 512) + conv(3, 64, 64, 512)
    h, c = 512, 64
    for _ in range(4):  # down
        h //= 2
        total += conv(3, c, 2 * c, h) + conv(3, 2 * c, 2 * c, h)
        c *= 2
    for _ in range(4):  # up: transposed conv from h, then two convs at 2h
        total += 2 * 4 * c * (c // 2) * h * h
        h *= 2
        total += conv(3, c, c // 2, h) + conv(3, c // 2, c // 2, h)
        c //= 2
    return total + conv(1, 64, 3, 512)


def transunet_forward():
    total = conv(7, 3, 64, 256)
    # (cin, cout, cmid, input size, output size) of each unit
    units = [(64, 256, 64, 127, 127)] + [(256, 256, 64, 127, 127)] * 2
    units += [(256, 512, 128, 127, 64)] + [(512, 512, 128, 64, 64)] * 3
    units += [(512, 1024, 256, 64, 32)] + [(1024, 1024, 256, 32, 32)] * 8
    for cin, cout, cmid, hi, ho in units:
        total += conv(1, cin, cmid, hi) + conv(3, cmid, cmid, ho)
        total += conv(1, cmid, cout, ho)
        if cin != cout:
            total += conv(1, cin, cout, ho)
    n, d, f = 1024, 768, 3072
    total += 2 * n * 1024 * d  # patch embedding
    layer = 4 * 2 * n * d * d + 2 * 2 * n * n * d + 2 * 2 * n * d * f
    total += 12 * layer
    total += conv(3, 768, 512, 32)
    for cin, cout, h in [(1024, 256, 64), (512, 128, 128), (192, 64, 256),
                         (64, 16, 512)]:
        total += conv(3, cin, cout, h) + conv(3, cout, cout, h)
    return total + conv(3, 16, 3, 512)


def _count(config, train):
    return flops.count(spec.cell(f"{config}.eval")["config_spec"], train)[0]


def test_unet64_forward():
    assert _count("unet64_mc", False) == unet64_forward()
    assert unet64_forward() / 2 == pytest.approx(192.7e9, rel=1e-3)


def test_unet64_train_is_forward_and_both_gradients():
    first = conv(3, 3, 64, 512)  # the input needs no gradient
    assert _count("unet64_mc", True) == 3 * unet64_forward() - first


def test_transunet_forward():
    assert _count("transunet_r50_b16", False) == transunet_forward()


def test_transunet_train_is_forward_and_both_gradients():
    first = conv(7, 3, 64, 256)
    assert _count("transunet_r50_b16", True) == 3 * transunet_forward() - first
