"""Drive the PyTorch port's main paths once on one CUDA GPU and check them.

    python3 chip_smoke.py

Builds the Hopper kernels from unet_torch_tpu_torch/csrc, then:

  1. device     the card's name and power limit; fails without a GPU
  2. build      nvcc of both kernels (fused conv3x3+BN+ReLU, flash attention
                forward), one process each, all at once; timed
  3. kernel     the fused conv against its plain PyTorch version at every
                distinct conv shape of the UNet-64 eval forward (batch 8,
                512x512 input), in bf16 and in f32 with TF32 off; errors and
                median times (CUDA events)
  4. main       UNet-64 eval forward through make_predict_fn(classes=True),
                bf16, batch 8 at 512x512, as configs/segmentation_mc.yml
                serves it; counts the kernel's launches, times the forward
  5. model      one 512x512 image through the same model in f32 on the card
                (kernel) and on the CPU (plain version); logits and class maps
                must agree
  6. attention  the attention kernel against its plain version at the ViT's
                shape (8, 12, 1024, 64) and at a ragged masked shape, in bf16
                and f32; errors, median times, TFLOP/s
  7. kernel     the fused conv at the nine conv shapes of the TransUnet
                decoder (batch 8, 512x512 input), as in phase 3
  8. main       TransUnet R50-ViT-B/16 eval forward through
                make_predict_fn(classes=True), bf16, batch 8 at 512x512, as
                configs/transunet.yml serves it; counts both kernels'
                launches (12 attention, 9 fused conv), times the forward
  9. model      one 512x512 image through the TransUnet in f32, card against
                CPU, as in phase 5; the CPU reference runs at the full
                512x512 (about 1.5 s with the card's host)

Any failure raises and the script exits nonzero. The last line of stdout is
{"ok": true, "device": {...}}; the line before it is one JSON object with the
kernels' numbers; the line before that is nvidia-smi's name and power limit.
Weights are random, from a seed; nothing is downloaded.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCH = 8
SIZE = 512
BASE = 64
N_CLASSES = 3
REPS = 10
# inputs are N(0, 1) and weights kaiming-scaled, so outputs are O(1-10).
# f32: the kernel and cuDNN (TF32 off) sum up to 9*1024 products in other
# orders. bf16: the plain version rounds the conv output to bf16 before the
# affine and once more after it, the kernel rounds once, so they may differ
# by two bf16 ulps (2**-7 each) of the largest output.
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# whole model, f32, card against CPU: 23 layers of sums in other orders.
# Read on an H100: 1.8e-5 against a peak of 15.5, 1.2e-6 of it. The bound
# leaves about 9x that, and stays well under TF32's input rounding (2**-11).
MODEL_REL_TOL = 1e-5
MIN_PIXEL_AGREEMENT = 0.999
# attention, kernel against plain, relative to max|v| (every output row is
# a convex combination of rows of v). bf16: both round the probabilities to
# bf16 (at most 2**-9 of max|v| each, at different points: the plain version
# after normalising, the kernel before) and the output once, so they differ
# by at most 2**-7 of max|v|. f32: scores and sums in other orders and exp
# implementations, about 1e-6 of max|v|; the bound leaves 10x.
ATTN_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# ((B, H, Nq, Nk, Dqk, Dv), masked): the ViT's attention at 512x512, and
# CLTR's kind of call: Dqk != Dv, Nq and Nk off the 64-row tiles, a padding
# mask
ATTN_CASES = [((BATCH, 12, 1024, 1024, 64, 64), False),
              ((3, 4, 100, 77, 64, 32), True)]
# TransUnet, whole model, f32, card against CPU, relative to the logits'
# peak: 16 bottlenecks, 12 ViT layers and 10 decoder convs of sums in other
# orders. Read on an H100: 6.9e-5 against a peak of 6.6, 1.05e-5 of it. The
# bound leaves about 9.5x that, and stays under TF32's input rounding.
TRANSUNET_REL_TOL = 1e-4


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def conv_shapes(base: int, size: int):
    """(H, Cin, Cout) of the 18 conv3x3+BN+ReLU layers of a UNet forward, in
    order: inc, down1-4, up1-4, two convs each."""
    level = [(size >> i, base << i) for i in range(5)]
    h, c = level[0]
    shapes = [(h, 3, c), (h, c, c)]
    for h, c in level[1:]:
        shapes += [(h, c // 2, c), (h, c, c)]
    for h, c in reversed(level[:4]):
        shapes += [(h, 2 * c, c), (h, c, c)]
    return shapes


def median_ms(fn, reps=REPS, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_inputs(b, h, cin, cout, dtype, gen):
    x = torch.randn(b, h, h, cin, generator=gen)
    w = torch.randn(3, 3, cin, cout, generator=gen) * (2.0 / (9 * cin)) ** 0.5
    gamma = torch.rand(cout, generator=gen) + 0.5
    beta = torch.randn(cout, generator=gen) * 0.1
    mean = torch.randn(cout, generator=gen) * 0.1
    var = torch.rand(cout, generator=gen) + 0.5
    return x, w, (gamma, beta, mean, var)


def check_kernel(fc, shapes, dev):
    """Phases 3 and 7. Returns {dtype: {(H, Cin, Cout): (err, ms,
    plain_ms)}}."""
    gen = torch.Generator().manual_seed(SEED)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        per_shape = {}
        for h, cin, cout in dict.fromkeys(shapes):
            x, w, bn = kernel_inputs(BATCH, h, cin, cout, dtype, gen)
            x, w = x.to(dev, dtype), w.to(dev, dtype)
            scale, bias = fc.fold_bn(*(t.to(dev) for t in bn))
            with torch.inference_mode():
                out = fc.fused_conv3x3_bn_relu(x, w, scale, bias)
                torch.cuda.synchronize()
                ref = fc.fused_conv3x3_bn_relu_reference(x, w, scale, bias)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                peak = ref.float().abs().max().item()
                bound = REL_TOL[dtype] * peak
                if not (out.shape == ref.shape and out.dtype == dtype
                        and err <= bound):
                    raise AssertionError(
                        f"kernel disagrees with plain at H={h} Cin={cin} "
                        f"Cout={cout} {dtype}: max_abs_err {err} > {bound}")
                ms = median_ms(
                    lambda: fc.fused_conv3x3_bn_relu(x, w, scale, bias))
                plain_ms = median_ms(
                    lambda: fc.fused_conv3x3_bn_relu_reference(
                        x, w, scale, bias))
            per_shape[(h, cin, cout)] = (err, ms, plain_ms)
            tflops = 2 * 9 * cin * cout * BATCH * h * h / ms / 1e9
            phase("kernel",
                  f"{str(dtype)[6:]} B={BATCH} H=W={h} Cin={cin} Cout={cout}"
                  f" max_abs_err={err:.3e} (bound {bound:.3e}) kernel "
                  f"{ms:.4f} ms ({tflops:.1f} TFLOP/s) plain {plain_ms:.4f} ms")
            del x, w, out, ref
        results[dtype] = per_shape
    return results


def seed_bn_stats(model, gen):
    """Seeded, non-trivial BN affine and running statistics (mean 0 / var 1
    would make the folding trivial)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_mean.copy_(
                    torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(
                    torch.rand(m.num_features, generator=gen) + 0.5)
    return model


def seeded_unet(gen):
    """UNet-64 3->3 with seeded weights and BN statistics."""
    from unet_torch_tpu_torch.models.unet import build_model

    return seed_bn_stats(build_model("single", n_channels=3,
                                     n_classes=N_CLASSES, base=BASE,
                                     generator=gen), gen)


def seeded_transunet(gen):
    """TransUnet R50-ViT-B/16 at 512x512, 3 classes, as configs/transunet.yml
    builds it, with seeded weights, BN statistics and position embeddings.
    The decoder's and head's convs are drawn kaiming-normal (gain sqrt 2):
    torch's default conv init shrinks the variance 3x per conv, so after the
    decoder's nine the BN shifts, not the image, would decide the logits."""
    from unet_torch_tpu_torch.models.transunet.vit import build_transunet

    model = build_transunet("TransUnet", img_size=SIZE,
                            num_classes=N_CLASSES, generator=gen)
    pos = model.transformer.embeddings.position_embeddings
    with torch.no_grad():
        pos.copy_(torch.randn(pos.shape, generator=gen) * 0.02)
        for part in (model.decoder, model.segmentation_head):
            for m in part.modules():
                if isinstance(m, torch.nn.Conv2d):
                    torch.nn.init.kaiming_normal_(m.weight, generator=gen)
    return seed_bn_stats(model, gen)


def transunet_conv_shapes(size):
    """(H, Cin, Cout) of the nine Conv2dReLUs of the TransUnet decoder at a
    size x size input: conv_more, then two per DecoderBlock, whose first conv
    takes the upsampled input with the ResNetV2 skip concatenated (512, 256,
    64 channels; none in the last block)."""
    h = size // 16
    shapes = [(h, 768, 512)]
    cin = 512
    for cout, skip in ((256, 512), (128, 256), (64, 64), (16, 0)):
        h *= 2
        shapes += [(h, cin + skip, cout), (h, cout, cout)]
        cin = cout
    return shapes


def attention_inputs(shape, masked, gen):
    """q, k, v from N(0, 1), and with `masked` a padding mask: batch row 0
    pads the second half of its keys, row 1 all of them (its output is the
    mean of its rows of v), the others none."""
    b, h, nq, nk, dqk, dv = shape
    q = torch.randn(b, h, nq, dqk, generator=gen)
    k = torch.randn(b, h, nk, dqk, generator=gen)
    v = torch.randn(b, h, nk, dv, generator=gen)
    mask = None
    if masked:
        mask = torch.zeros(b, nk, dtype=torch.bool)
        mask[0, nk // 2:] = True
        mask[1, :] = True
    return q, k, v, mask


def check_attention(at, dev):
    """Phase 6. Returns {dtype: {shape: (err, ms, plain_ms)}}."""
    gen = torch.Generator().manual_seed(SEED)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        per_shape = {}
        for shape, masked in ATTN_CASES:
            b, h, nq, nk, dqk, dv = shape
            q, k, v, mask = attention_inputs(shape, masked, gen)
            q, k, v = (t.to(dev, dtype) for t in (q, k, v))
            mask = None if mask is None else mask.to(dev)
            bias = None if mask is None else at.padding_bias(mask)
            scale = dqk ** -0.5
            with torch.inference_mode():
                out = at.fused_attention(q, k, v, key_padding_mask=mask)
                torch.cuda.synchronize()
                ref = at.attention_reference(q, k, v, scale, bias)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                bound = ATTN_REL_TOL[dtype] * v.float().abs().max().item()
                if not (out.shape == ref.shape and out.dtype == dtype
                        and torch.isfinite(out).all() and err <= bound):
                    raise AssertionError(
                        f"attention kernel disagrees with plain at {shape} "
                        f"{dtype}: max_abs_err {err} > {bound}")
                ms = median_ms(lambda: at.fused_attention(
                    q, k, v, key_padding_mask=mask))
                plain_ms = median_ms(
                    lambda: at.attention_reference(q, k, v, scale, bias))
            per_shape[shape] = (err, ms, plain_ms)
            tflops = 2 * b * h * nq * nk * (dqk + dv) / ms / 1e9
            phase("attention",
                  f"{str(dtype)[6:]} (B,H,Nq,Nk,Dqk,Dv)={shape} "
                  f"masked={mask is not None} max_abs_err={err:.3e} (bound "
                  f"{bound:.3e}) kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s) "
                  f"plain {plain_ms:.4f} ms")
            del q, k, v, out, ref
        results[dtype] = per_shape
    return results


def forward_s(fn, xs):
    """Median host time of fn(xs) over REPS calls after 2 warm-ups, each
    ending in a device sync."""
    times = []
    for _ in range(REPS + 2):
        t0 = time.perf_counter()
        fn(xs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[2:])


def check_model_f32(name, model, cpu_model, xs, dev, rel_tol):
    """Phases 5 and 9: one image in f32, card (kernels) against CPU (plain
    versions)."""
    x1 = torch.from_numpy(xs[:1])
    with torch.inference_mode():
        gpu = model(x1.to(dev)).cpu()
        cpu = cpu_model(x1)
    err = (gpu - cpu).abs().max().item()
    bound = rel_tol * cpu.abs().max().item()
    agree = (gpu.argmax(-1) == cpu.argmax(-1)).float().mean().item()
    if not (torch.isfinite(gpu).all() and gpu.shape == (1, SIZE, SIZE,
                                                        N_CLASSES)):
        raise AssertionError(f"bad {name} logits {gpu.shape}")
    if err > bound or agree < MIN_PIXEL_AGREEMENT:
        raise AssertionError(f"{name} card vs CPU: max_abs_err {err} (bound "
                             f"{bound}), pixel agreement {agree}")
    phase("model", f"{name} f32 {SIZE}x{SIZE} card vs CPU: max_abs_err "
          f"{err:.3e} (bound {bound:.3e}, peak {cpu.abs().max().item():.3e})"
          f", class maps agree on {agree * 100:.4f}% of pixels")


def check_classes(classes):
    classes = classes.cpu().numpy()
    if classes.shape != (BATCH, SIZE, SIZE) or classes.dtype != np.uint8:
        raise AssertionError(f"class map {classes.shape} {classes.dtype}")
    hist = np.bincount(classes.ravel(), minlength=N_CLASSES)
    if hist.size != N_CLASSES:
        raise AssertionError(f"class ids outside [0, {N_CLASSES}): {hist}")
    return hist


def eval_batch(rng, n_cells=40, radius=(6, 14)):
    """BATCH synthetic cell images (dark disks of random colour on a noisy
    light background), z-normalised per image and channel as the eval
    preprocess does."""
    yy, xx = np.mgrid[:SIZE, :SIZE]
    x = 200.0 + 10.0 * rng.standard_normal((BATCH, SIZE, SIZE, 3))
    for img in x:
        for cy, cx, r in zip(rng.randint(0, SIZE, n_cells),
                             rng.randint(0, SIZE, n_cells),
                             rng.randint(*radius, n_cells)):
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.uniform(
                40, 160, 3)
    x = x.astype(np.float32)
    mean = x.mean(axis=(1, 2), keepdims=True)
    std = x.std(axis=(1, 2), keepdims=True)
    return (x - mean) / std


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    phase("device", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" CUDA {torch.version.cuda} | count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.eval.reports import make_predict_fn
    from unet_torch_tpu_torch.kernels import attention as at
    from unet_torch_tpu_torch.kernels import build
    from unet_torch_tpu_torch.kernels import fused_conv as fc
    from unet_torch_tpu_torch.models.transunet import vit
    from unet_torch_tpu_torch.nn import blocks

    # 2. build
    start = time.perf_counter()
    libs = build.build_all(["fused_conv3x3_bn_relu", "flash_attention_fwd"])
    fc._library()
    at._library()
    build_s = time.perf_counter() - start
    phase("build", f"{', '.join(p.name for p in libs)} built and loaded in "
          f"{build_s:.2f} s")

    # 3. fused conv against plain, at the UNet's shapes
    shapes = conv_shapes(BASE, SIZE)
    assert len(shapes) == 18
    kres = check_kernel(fc, shapes, dev)

    # 4. the UNet main path: UNet-64 eval forward, bf16, batch 8, 512x512
    model = seeded_unet(seed_everything(SEED))
    cpu_model = copy.deepcopy(model).eval()
    xs = eval_batch(np.random.RandomState(SEED))
    predict = make_predict_fn(model, dev, torch.bfloat16, classes=True)
    fc.fused_conv3x3_bn_relu.launches = 0
    at.fused_attention.launches = 0
    classes = predict(xs)
    torch.cuda.synchronize()
    unet_launches = fc.fused_conv3x3_bn_relu.launches
    if unet_launches != len(shapes) or at.fused_attention.launches:
        raise AssertionError(f"{unet_launches} fused conv and "
                             f"{at.fused_attention.launches} attention "
                             f"launches in one UNet forward, expected "
                             f"{len(shapes)} and 0")
    hist = check_classes(classes)
    fwd_s = forward_s(predict, xs)
    # the same forward with the plain version in place of the kernel, for
    # comparison only
    blocks.fused_conv3x3_bn_relu = fc.fused_conv3x3_bn_relu_reference
    try:
        plain_fwd_s = forward_s(predict, xs)
    finally:
        blocks.fused_conv3x3_bn_relu = fc.fused_conv3x3_bn_relu
    phase("main", f"UNet-{BASE} eval forward bf16 B={BATCH} {SIZE}x{SIZE}: "
          f"{unet_launches} kernel launches; class histogram "
          f"{hist.tolist()}; median {fwd_s * 1e3:.2f} ms = "
          f"{BATCH / fwd_s:.1f} img/s (plain convs {plain_fwd_s * 1e3:.2f} "
          f"ms = {BATCH / plain_fwd_s:.1f} img/s)")

    # 5. the UNet in f32, card (kernel) against CPU (plain)
    check_model_f32(f"UNet-{BASE}", model, cpu_model, xs, dev,
                    MODEL_REL_TOL)
    del model, cpu_model, predict

    # 6. attention against plain
    ares = check_attention(at, dev)

    # 7. fused conv against plain, at the TransUnet decoder's shapes
    tu_shapes = transunet_conv_shapes(SIZE)
    assert len(tu_shapes) == 9
    tres = check_kernel(fc, tu_shapes, dev)

    # 8. the TransUnet main path: eval forward, bf16, batch 8, 512x512
    model = seeded_transunet(seed_everything(SEED))
    cpu_model = copy.deepcopy(model).eval()
    predict = make_predict_fn(model, dev, torch.bfloat16, classes=True)
    fc.fused_conv3x3_bn_relu.launches = 0
    at.fused_attention.launches = 0
    classes = predict(xs)
    torch.cuda.synchronize()
    tu_conv_launches = fc.fused_conv3x3_bn_relu.launches
    attn_launches = at.fused_attention.launches
    n_layers = len(model.transformer.encoder.layer)
    if (attn_launches, tu_conv_launches) != (n_layers, len(tu_shapes)):
        raise AssertionError(f"{attn_launches} attention and "
                             f"{tu_conv_launches} fused conv launches in one "
                             f"TransUnet forward, expected {n_layers} and "
                             f"{len(tu_shapes)}")
    hist = check_classes(classes)
    tu_fwd_s = forward_s(predict, xs)
    # both plain versions swapped in, for comparison only
    vit.fused_attention = lambda q, k, v, scale: at.attention_reference(
        q, k, v, scale)
    vit.fused_conv3x3_bn_relu = fc.fused_conv3x3_bn_relu_reference
    try:
        tu_plain_fwd_s = forward_s(predict, xs)
    finally:
        vit.fused_attention = at.fused_attention
        vit.fused_conv3x3_bn_relu = fc.fused_conv3x3_bn_relu
    phase("main", f"TransUnet R50-ViT-B/16 eval forward bf16 B={BATCH} "
          f"{SIZE}x{SIZE}: {attn_launches} attention and {tu_conv_launches} "
          f"fused conv launches; class histogram {hist.tolist()}; median "
          f"{tu_fwd_s * 1e3:.2f} ms = {BATCH / tu_fwd_s:.1f} img/s (plain "
          f"attention and convs {tu_plain_fwd_s * 1e3:.2f} ms = "
          f"{BATCH / tu_plain_fwd_s:.1f} img/s)")

    # 9. the TransUnet in f32, card (kernels) against CPU (plain)
    start = time.perf_counter()
    check_model_f32("TransUnet", model, cpu_model, xs, dev,
                    TRANSUNET_REL_TOL)
    phase("model", f"TransUnet card + CPU f32 check took "
          f"{time.perf_counter() - start:.1f} s")

    jax_side = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "unet_torch_tpu"))
    if jax_side:
        raise AssertionError(f"the port's main path imported {jax_side}")

    conv_bf16 = {**kres[torch.bfloat16], **tres[torch.bfloat16]}
    vit_shape = ATTN_CASES[0][0]
    attn_bf16 = ares[torch.bfloat16]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_conv3x3_bn_relu",
        "route": "cuda",
        "source": "unet_torch_tpu_torch/csrc/fused_conv3x3_bn_relu.cu",
        "replaces": "unet_torch_tpu/kernels/fused_conv.py:40",
        "also_replaces": "unet_torch_tpu/kernels/fused_conv.py:92",
        # the UNet's 18 and the TransUnet's 9 launches of one forward each
        "launches": unet_launches + tu_conv_launches,
        "launches_by_path": {"unet": unet_launches,
                             "transunet": tu_conv_launches},
        "max_abs_err": max(e for e, _, _ in conv_bf16.values()),
        # bf16, summed over those 27 launches
        "ms": sum(conv_bf16[s][1] for s in shapes + tu_shapes),
        "plain_ms": sum(conv_bf16[s][2] for s in shapes + tu_shapes),
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "unet_torch_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "unet_torch_tpu/kernels/attention.py:68",
        "also_replaces": "unet_torch_tpu/kernels/attention.py:140",
        "launches": attn_launches,
        "launches_by_path": {"transunet": attn_launches},
        "max_abs_err": max(e for e, _, _ in attn_bf16.values()),
        # bf16, the ViT's shape, summed over the 12 launches of a forward
        "ms": attn_launches * attn_bf16[vit_shape][1],
        "plain_ms": attn_launches * attn_bf16[vit_shape][2],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
