"""Synthetic dataset fixture — random cell-like images + all label formats.

The reference repo ships no tests and its datasets point at hardcoded user paths
(SURVEY.md §2.6); this generator writes a tiny on-disk dataset matching every
label-file convention the loaders expect, so train/eval runs end-to-end in tests
and benchmarks without real pathology data.
"""

from __future__ import annotations

import os

import numpy as np


def make_blob_sample(rng, size=64, n_cells=5, n_classes=3):
    """Returns (rgb uint8, class mask uint8, dot map uint8, density f32)."""
    img = np.full((size, size, 3), 230, np.uint8)
    mask = np.zeros((size, size), np.uint8)
    dots = np.zeros((size, size), np.uint8)
    density = np.zeros((size, size), np.float32)
    yy, xx = np.mgrid[:size, :size]
    for _ in range(n_cells):
        cy, cx = rng.randint(6, size - 6, size=2)
        r = rng.randint(3, 6)
        cls = rng.randint(1, n_classes)
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        mask[blob] = cls
        dots[cy, cx] = 1
        g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * (r / 2) ** 2))
        density += (g / g.sum()).astype(np.float32)
        color = np.array([120, 60, 160]) + rng.randint(-30, 30, size=3)
        img[blob] = np.clip(color, 0, 255)
    return img, mask, dots, density


def write_synthetic_dataset(root: str, n_images: int = 4, size: int = 64,
                            n_classes: int = 3, seed: int = 0,
                            grayscale: bool = False) -> str:
    """Write images + every label convention under ``root``; returns root."""
    import cv2

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n_images):
        img, mask, dots, density = make_blob_sample(rng, size, 5, n_classes)
        stem = os.path.join(root, f"img{i}")
        if grayscale:
            cv2.imwrite(stem + ".png", cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
        else:
            cv2.imwrite(stem + ".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        cv2.imwrite(stem + "_label_mc.png", mask)
        cv2.imwrite(stem + "_label.png", (mask > 0).astype(np.uint8))
        cv2.imwrite(stem + "_gt_dot.png", dots)
        np.save(stem + "_label_reg.npy", density)
        np.save(stem + "_label_immune_reg.npy", density * (mask == 1).mean())
        np.save(stem + "_label_other_reg.npy", density * (mask == 2).mean())
        # TSV point annotations (x,y doubled: loader halves them, ref :873-874)
        ys, xs = np.nonzero(dots)
        with open(stem + ".tsv", "w") as f:
            f.write("x\ty\tclass\n")
            for y, x in zip(ys, xs):
                f.write(f"{2 * (x + 1)}\t{2 * (y + 1)}\tTumor\n")
    return root
