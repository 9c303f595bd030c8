"""Synthetic H&E-like tiles: a pale background with round cells of two
classes, each tile from its own seeded generator. Adapted from the port's
smoke-test dataset writer (blob cells as in data/synthetic.py), with each
cell drawn in its own box so that a 512x512 tile costs milliseconds.

`write_tiles` writes the files DataBinary reads: `<stem>.png` (BGR), its
class mask `<stem>_label_mc.png` and its dot map `<stem>_gt_dot.png` (each
cell's centre, coded by the class left there)."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def tile(seed: int, k: int, size: int, n_cells: int, n_classes: int):
    """(rgb uint8 (size, size, 3), class mask uint8, dot map uint8) of tile
    k."""
    rng = np.random.RandomState([seed, k])
    img = np.full((size, size, 3), 230, np.uint8)
    mask = np.zeros((size, size), np.uint8)
    dots = np.zeros((size, size), np.uint8)
    for _ in range(n_cells):
        cy, cx = rng.randint(6, size - 6, size=2)
        r = rng.randint(3, 6)
        cls = rng.randint(1, n_classes)
        color = np.clip(np.array([120, 60, 160]) + rng.randint(-30, 30, 3),
                        0, 255)
        y0, y1 = max(cy - r, 0), min(cy + r + 1, size)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, size)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        mask[y0:y1, x0:x1][blob] = cls
        img[y0:y1, x0:x1][blob] = color
        dots[cy, cx] = 1
    return img, mask, dots * mask


def stem(k: int) -> str:
    """Tile k's file stem: zero-padded, so that name order is tile order."""
    return f"tile{k:05d}"


def write_tiles(root: str, seed: int, n: int, size: int, n_cells: int,
                n_classes: int, threads: int = 8) -> str:
    import cv2

    os.makedirs(root, exist_ok=True)

    def write(k):
        img, mask, dots = tile(seed, k, size, n_cells, n_classes)
        base = os.path.join(root, stem(k))
        cv2.imwrite(base + ".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        cv2.imwrite(base + "_label_mc.png", mask)
        cv2.imwrite(base + "_gt_dot.png", dots)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(write, range(n)))
    return root


def z_normalize(img: np.ndarray) -> np.ndarray:
    """Per-channel z-normalisation over (H, W) with the population std: the
    statistics in float64 (cv2.meanStdDev), rounded to float32, then the
    image less its mean over its std in float32. The statistics come from
    the same library call as the loader's, so that the check can compare
    the loader's rows exactly: two float64 sums in different orders round
    to float32 apart about once in a few thousand channels."""
    import cv2

    x = np.asarray(img, np.float32)
    mean, std = cv2.meanStdDev(x)
    c = x.shape[2]
    return ((x - mean.reshape(-1)[:c].astype(np.float32))
            / std.reshape(-1)[:c].astype(np.float32))


def pool(seed: int, n: int, size: int, n_cells: int, n_classes: int,
         threads: int = 8) -> np.ndarray:
    """n preprocessed tiles in host memory, (n, size, size, 3) float32."""
    def one(k):
        return z_normalize(tile(seed, k, size, n_cells, n_classes)[0])

    with ThreadPoolExecutor(threads) as ex:
        return np.stack(list(ex.map(one, range(n))))
