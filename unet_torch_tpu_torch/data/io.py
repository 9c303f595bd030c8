"""Image decoding, discovery, resizing, normalisation — HWC/numpy host pipeline.

Mirrors the shared dataset behaviours of reference DataLoader.py:
  * channel-code decoding (ch 1/3/-1/-2, anydepth)            :377-391
  * recursive discovery, `_label`/`_gt_dot` exclusion,
    natural sort                                               :409-420,714-731
  * scipy.ndimage.zoom resize, order 3 image / order 0 label   :346-355
  * per-image z-normalisation over (H, W)                      :357-360

Our arrays stay channels-last (HWC) end to end — the reference transposes to CHW
and flips BGR->RGB (:363-366); we decode straight to RGB HWC.
The reference's zoom swaps the width/height factors (harmless on square inputs,
DataLoader.py:349 `(width/x, height/y)` where axis 0 is y); we scale each axis
by its own factor.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence

import numpy as np

IMAGE_EXT = [".jpg", ".jpeg", ".webp", ".bmp", ".png", ".tif", ".PNG", ".tiff"]


def natural_sort(items: Sequence[str]) -> list[str]:
    def convert(text):
        return int(text) if text.isdigit() else text.lower()

    def alphanum_key(key):
        return [convert(c) for c in re.split("([0-9]+)", key)]

    return sorted(items, key=alphanum_key)


def get_image_list(paths, exclude=("_label", "_gt_dot")) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    image_paths = []
    for current in paths:
        for maindir, _subdir, files in os.walk(current):
            for filename in files:
                if any(tag in filename for tag in exclude):
                    continue
                apath = os.path.join(maindir, filename)
                if os.path.splitext(apath)[1] in IMAGE_EXT:
                    image_paths.append(apath)
    return natural_sort(image_paths)


def decode_image(img_path: str, channel: int, anydepth: bool = False,
                 normalizer=None) -> np.ndarray:
    """Decode by channel code.  Returns HWC float/uint arrays (grayscale keeps
    2D (H, W) until `to_model_input`)."""
    import cv2

    if channel == 1:
        flag = -1 if anydepth else 0
        return cv2.imread(img_path, flag)
    if channel == 3:
        bgr = cv2.imread(img_path)
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    if channel == -1:
        from unet_torch_tpu_torch.data.stain import hematoxylin_channel

        rgb = cv2.cvtColor(cv2.imread(img_path), cv2.COLOR_BGR2RGB)
        return hematoxylin_channel(rgb)
    if channel == -2:
        rgb = cv2.cvtColor(cv2.imread(img_path), cv2.COLOR_BGR2RGB)
        if normalizer is None:
            raise ValueError("channel=-2 requires a fitted MacenkoNormalizer")
        return normalizer.transform(rgb)
    raise ValueError(f"Unknown channel code {channel}")


def zoom_resize(arr: np.ndarray, height: int, width: int,
                order: int) -> np.ndarray:
    """scipy.ndimage.zoom to (height, width); order 3 for images, 0 for labels."""
    from scipy.ndimage import zoom

    if arr.shape[0] == height and arr.shape[1] == width:
        return arr
    factors = (height / arr.shape[0], width / arr.shape[1])
    if arr.ndim == 3:
        factors = factors + (1,)
    return zoom(arr, factors, order=order)


def z_normalize(img: np.ndarray) -> np.ndarray:
    """Per-image, per-channel z-norm over the spatial dims (DataLoader.py:357-360).

    Stats via cv2.meanStdDev (SIMD, f64 accumulators; np.std dominated a
    warm __getitem__) and an
    in-place f32 normalise; same population-std definition as np.std."""
    import cv2

    arr = np.asarray(img)
    if arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] <= 4):
        mean, std = cv2.meanStdDev(arr)
        c = 1 if arr.ndim == 2 else arr.shape[2]
        mean = mean.reshape(-1)[:c].astype(np.float32)
        std = std.reshape(-1)[:c].astype(np.float32)
        out = arr.astype(np.float32, copy=True)
        if arr.ndim == 2:
            out -= mean[0]
            out /= std[0]
        else:
            out -= mean
            out /= std
        return out
    mean = np.mean(arr, axis=(0, 1))
    std = np.std(arr, axis=(0, 1))
    return (arr - mean) / std


def to_model_input(img: np.ndarray) -> np.ndarray:
    """HWC float32 with an explicit channel dim (grayscale (H,W) -> (H,W,1))."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def load_and_preprocess(img_path: str, channel: int, input_size,
                        anydepth: bool = False, normalizer=None) -> np.ndarray:
    """The standard eval-path preprocess (test.py:77-80 semantics): decode,
    zoom to input_size, z-norm, HWC float32."""
    img = decode_image(img_path, channel, anydepth, normalizer)
    img = zoom_resize(img, input_size[0], input_size[1], order=3)
    img = z_normalize(img)
    return to_model_input(img)
