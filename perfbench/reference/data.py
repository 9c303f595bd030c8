"""The train loader's batches as the plain reference works them out from the
files and the seed: the file list, the shuffled order of each epoch, each
sample's augmentation draws, the decode and the z-normalisation.

The draws: the dataset's generator (numpy RandomState(seed)) gives one
child seed a sample, in the order its loader threads reach it, so the set
of a batch's child seeds is fixed by the seed but which sample gets which
is not. `candidates` therefore returns, for each row of a batch, the row
under every child seed of that batch; the check finds the one the program
used, from the labels first and the images of the best ones.
Augmentation: with probability 1/2 a rot90 by k and a flip along an
axis; else with 1/4 a rotation by a whole angle in [-20, 20) about the
centre, nearest neighbour, zero fill (cv2.warpAffine); else nothing. The
PNGs are decoded with cv2."""

from __future__ import annotations

import os

import numpy as np

from perfbench.core.tiles import z_normalize


def image_list(root: str) -> list:
    names = sorted(n for n in os.listdir(root) if n.endswith(".png")
                   and "_label" not in n and "_gt_dot" not in n)
    return [os.path.join(root, n) for n in names]


def epoch_orders(n: int, seed: int, epochs: int) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(epochs):
        idx = np.arange(n)
        rng.shuffle(idx)
        out.append(idx)
    return out


def child_seeds(seed: int, count: int) -> list:
    rng = np.random.RandomState(seed)
    return [int(rng.randint(0, 2 ** 31 - 1)) for _ in range(count)]


def decode(path: str):
    import cv2

    image = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    label = cv2.imread(path.replace(".png", "_label_mc.png"), 0)
    return image, label


def augment(arrays, child_seed: int):
    import cv2

    rng = np.random.RandomState(child_seed)
    if rng.random_sample() > 0.5:
        k = rng.randint(0, 4)
        axis = rng.randint(0, 2)
        return [np.flip(np.rot90(a, k), axis=axis).copy() for a in arrays]
    if rng.random_sample() > 0.5:
        angle = rng.randint(-20, 20)
        out = []
        for a in arrays:
            h, w = a.shape[:2]
            mat = cv2.getRotationMatrix2D(((w - 1) / 2.0, (h - 1) / 2.0),
                                          angle, 1.0)
            out.append(cv2.warpAffine(a, mat, (w, h), flags=cv2.INTER_NEAREST,
                                      borderMode=cv2.BORDER_CONSTANT,
                                      borderValue=0).reshape(a.shape))
        return out
    return list(arrays)


def batch_rows(order, step: int, batch: int, seeds):
    """(sample indices, child seeds) of train step `step` (0-based, within
    the first epoch)."""
    return (order[step * batch:(step + 1) * batch],
            seeds[step * batch:(step + 1) * batch])


def label_under(label, child_seed):
    """The label of a sample under one child seed's draws (the draws do not
    depend on the arrays, so the image is left out here)."""
    return np.asarray(augment([label], child_seed)[0], np.int32)


def image_under(image, child_seed):
    """The model input of a sample under one child seed's draws."""
    return z_normalize(augment([image], child_seed)[0])
