"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Builds the Hopper kernel from unet_torch_tpu_torch/csrc, then:

  1. device   the card's name and power limit; fails without a GPU
  2. build    nvcc of the fused conv3x3+BN+ReLU kernel, timed
  3. kernel   against its plain PyTorch version at every distinct conv shape
              of the UNet-64 eval forward (batch 8, 512x512 input), in bf16
              and in f32 with TF32 off; errors and median times (CUDA events)
  4. main     UNet-64 eval forward through make_predict_fn(classes=True), bf16,
              batch 8 at 512x512, as configs/segmentation_mc.yml serves it;
              counts the kernel's launches, times the forward
  5. model    one 512x512 image through the same model in f32 on the card
              (kernel) and on the CPU (plain version); logits and class maps
              must agree

Any failure raises and the script exits nonzero. The last line of stdout is
{"ok": true, "device": {...}}; the line before it is one JSON object with the
kernel's numbers; the line before that is nvidia-smi's name and power limit.
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
    """Phase 3. Returns {dtype: {(H, Cin, Cout): (err, ms, plain_ms)}}."""
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


def seeded_unet(gen):
    """UNet-64 3->3 with seeded weights and seeded, non-trivial BN running
    statistics (mean 0 / var 1 would make the folding trivial)."""
    from unet_torch_tpu_torch.models.unet import build_model

    model = build_model("single", n_channels=3, n_classes=N_CLASSES,
                        base=BASE, generator=gen)
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
    from unet_torch_tpu_torch.kernels import build
    from unet_torch_tpu_torch.kernels import fused_conv as fc
    from unet_torch_tpu_torch.nn import blocks

    # 2. build
    start = time.perf_counter()
    lib_path = build.build("fused_conv3x3_bn_relu")
    fc._library()
    build_s = time.perf_counter() - start
    phase("build", f"{lib_path.name} built and loaded in {build_s:.2f} s")

    # 3. kernel against plain, at the main path's shapes
    shapes = conv_shapes(BASE, SIZE)
    assert len(shapes) == 18
    kres = check_kernel(fc, shapes, dev)

    # 4. the main path: UNet-64 eval forward, bf16, batch 8, 512x512
    model = seeded_unet(seed_everything(SEED))
    cpu_model = copy.deepcopy(model).eval()
    xs = eval_batch(np.random.RandomState(SEED))
    predict = make_predict_fn(model, dev, torch.bfloat16, classes=True)
    fc.fused_conv3x3_bn_relu.launches = 0
    classes = predict(xs)
    torch.cuda.synchronize()
    launches = fc.fused_conv3x3_bn_relu.launches
    if launches != len(shapes):
        raise AssertionError(f"{launches} kernel launches in one forward, "
                             f"expected {len(shapes)}")
    classes = classes.cpu().numpy()
    if classes.shape != (BATCH, SIZE, SIZE) or classes.dtype != np.uint8:
        raise AssertionError(f"class map {classes.shape} {classes.dtype}")
    hist = np.bincount(classes.ravel(), minlength=N_CLASSES)
    if hist.size != N_CLASSES:
        raise AssertionError(f"class ids outside [0, {N_CLASSES}): {hist}")

    def forward_s(fn):
        times = []
        for _ in range(REPS + 2):
            t0 = time.perf_counter()
            fn(xs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times[2:])

    fwd_s = forward_s(predict)
    # the same forward with the plain version in place of the kernel, for
    # comparison only
    blocks.fused_conv3x3_bn_relu = fc.fused_conv3x3_bn_relu_reference
    try:
        plain_fwd_s = forward_s(predict)
    finally:
        blocks.fused_conv3x3_bn_relu = fc.fused_conv3x3_bn_relu
    phase("main", f"UNet-{BASE} eval forward bf16 B={BATCH} {SIZE}x{SIZE}: "
          f"{launches} kernel launches; class histogram {hist.tolist()}; "
          f"median {fwd_s * 1e3:.2f} ms = {BATCH / fwd_s:.1f} img/s "
          f"(plain convs {plain_fwd_s * 1e3:.2f} ms = "
          f"{BATCH / plain_fwd_s:.1f} img/s)")

    # 5. the whole model in f32, card (kernel) against CPU (plain)
    x1 = torch.from_numpy(xs[:1])
    with torch.inference_mode():
        gpu = model(x1.to(dev)).cpu()
        cpu = cpu_model(x1)
    err = (gpu - cpu).abs().max().item()
    peak = cpu.abs().max().item()
    agree = (gpu.argmax(-1) == cpu.argmax(-1)).float().mean().item()
    if not (torch.isfinite(gpu).all() and gpu.shape == (1, SIZE, SIZE,
                                                        N_CLASSES)):
        raise AssertionError(f"bad logits {gpu.shape}")
    if err > MODEL_REL_TOL * peak or agree < MIN_PIXEL_AGREEMENT:
        raise AssertionError(f"card vs CPU: max_abs_err {err} (bound "
                             f"{MODEL_REL_TOL * peak}), pixel agreement "
                             f"{agree}")
    phase("model", f"f32 {SIZE}x{SIZE} card vs CPU: max_abs_err {err:.3e} "
          f"(bound {MODEL_REL_TOL * peak:.3e}), class maps agree on "
          f"{agree * 100:.4f}% of pixels")

    jax_side = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "unet_torch_tpu"))
    if jax_side:
        raise AssertionError(f"the port's main path imported {jax_side}")

    bf16 = kres[torch.bfloat16]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_conv3x3_bn_relu",
        "route": "cuda",
        "source": "unet_torch_tpu_torch/csrc/fused_conv3x3_bn_relu.cu",
        "replaces": "unet_torch_tpu/kernels/fused_conv.py:40",
        "launches": launches,
        "max_abs_err": max(e for e, _, _ in bf16.values()),
        # the 18 convs of one bf16 batch-8 forward, summed
        "ms": sum(bf16[s][1] for s in shapes),
        "plain_ms": sum(bf16[s][2] for s in shapes),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
