"""Variable-size batch assembly — the NestedTensor capability.

The reference pads mixed-size images into one tensor plus a padding mask
(reference CLTR/misc.py:292-337 nested_tensor_from_tensor_list); the
mask rides through the model so attention/pos-encoding ignore padding.  Here
the same contract is a plain (batch, mask) pair of numpy arrays — the
ConditionalDETR takes the mask explicitly.

Shapes are padded to multiples of ``bucket``, so that a few shapes occur
instead of one per image size.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def nested_batch(images: Sequence[np.ndarray], bucket: int = 32,
                 pad_value: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Stack HWC images of mixed sizes: returns (batch (B,H,W,C) padded to
    the bucketed max size, mask (B,H,W) bool — True ON PADDING, the
    reference's convention (misc.py:324-326))."""
    if not images:
        raise ValueError("empty image list")
    images = [np.asarray(im) for im in images]
    if any(im.ndim != 3 for im in images):
        images = [im[:, :, None] if im.ndim == 2 else im for im in images]
    h = _ceil_to(max(im.shape[0] for im in images), bucket)
    w = _ceil_to(max(im.shape[1] for im in images), bucket)
    c = images[0].shape[2]
    batch = np.full((len(images), h, w, c), pad_value, images[0].dtype)
    mask = np.ones((len(images), h, w), bool)
    for i, im in enumerate(images):
        batch[i, :im.shape[0], :im.shape[1]] = im
        mask[i, :im.shape[0], :im.shape[1]] = False
    return batch, mask


def nested_cltr_collate(batch):
    """CLTR train collate for mixed-size crops: flattens per-image patch
    lists (train.py:280-290 contract) and pads them into one (batch, mask)
    pair instead of requiring equal sizes."""
    imgs, targets = [], []
    for item in batch:
        imgs.extend(item[0])
        targets.extend(item[1])
    stacked, mask = nested_batch(imgs)
    return stacked, mask, targets


def pad_and_tile(image: np.ndarray, crop_size: int):
    """Cover the FULL image with crop_size tiles by zero-padding up to the
    next multiple (the reference's val tiling silently drops the
    non-multiple margin, DataLoader.py:826-842 / our datasets.py tiling).
    Returns (tiles (N,cs,cs,C), mask_tiles (N,cs,cs) bool True-on-padding,
    grid (rows, cols))."""
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, c = image.shape
    ph = _ceil_to(h, crop_size) - h
    pw = _ceil_to(w, crop_size) - w
    padded = np.pad(image, ((0, ph), (0, pw), (0, 0)))
    mask = np.ones(padded.shape[:2], bool)
    mask[:h, :w] = False
    rows = padded.shape[0] // crop_size
    cols = padded.shape[1] // crop_size
    tiles, mtiles = [], []
    for i in range(rows):
        for j in range(cols):
            sl = np.s_[i * crop_size:(i + 1) * crop_size,
                       j * crop_size:(j + 1) * crop_size]
            tiles.append(padded[sl])
            mtiles.append(mask[sl])
    return np.stack(tiles), np.stack(mtiles), (rows, cols)
