"""Stain-space transforms for histopathology: HED deconvolution + Macenko.

Capability parity with the reference's channel codes (DataLoader.py:377-391):
  ch == -1  RGB -> HED colour deconvolution, keep the hematoxylin channel
            (reference calls skimage.color.rgb2hed at DataLoader.py:386-388)
  ch == -2  Macenko stain normalisation fitted on a reference tile
            (reference uses staintools at DataLoader.py:239-243)

Neither skimage nor staintools exists in this image, so both are implemented
from first principles: Ruifrok-Johnston deconvolution with the standard
rgb_from_hed matrix, and the Macenko method (SVD of optical densities, robust
angle percentiles, 99th-percentile concentration scaling).
"""

from __future__ import annotations

import numpy as np

# Ruifrok & Johnston stain matrix (rows: H, E, DAB in RGB) — the same constants
# skimage.color uses.
RGB_FROM_HED = np.array([
    [0.65, 0.70, 0.29],
    [0.07, 0.99, 0.11],
    [0.27, 0.57, 0.78],
], dtype=np.float64)
HED_FROM_RGB = np.linalg.inv(RGB_FROM_HED)


def rgb2hed(rgb: np.ndarray) -> np.ndarray:
    """skimage-compatible HED separation of an RGB uint8/float image (H,W,3)."""
    img = rgb.astype(np.float64)
    if rgb.dtype == np.uint8:
        img = img / 255.0
    img = np.maximum(img, 1e-6)
    log_adjust = np.log(1e-6)
    stains = (np.log(img) / log_adjust) @ HED_FROM_RGB
    return np.maximum(stains, 0.0)


def hematoxylin_channel(rgb: np.ndarray) -> np.ndarray:
    """The ch==-1 decode: hematoxylin component of the HED separation."""
    return rgb2hed(rgb)[:, :, 0]


# ---------------------------------------------------------------------------
# Macenko stain normalisation
# ---------------------------------------------------------------------------

def _rgb_to_od(img: np.ndarray) -> np.ndarray:
    return -np.log((img.astype(np.float64) + 1.0) / 256.0)


def _stained_mask(img: np.ndarray, luminosity_threshold: float = 0.8):
    import cv2

    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    L = lab[:, :, 0].astype(np.float64) / 255.0
    return L < luminosity_threshold


def _macenko_stain_matrix(img: np.ndarray, beta_mask: float = 0.8,
                          angular_percentile: float = 99.0) -> np.ndarray:
    """2x3 row-normalised (H, E) stain matrix via the Macenko method."""
    mask = _stained_mask(img, beta_mask).reshape(-1)
    od = _rgb_to_od(img).reshape(-1, 3)[mask]
    if od.shape[0] < 10:
        od = _rgb_to_od(img).reshape(-1, 3)
    _, eigvecs = np.linalg.eigh(np.cov(od, rowvar=False))
    v = eigvecs[:, [2, 1]]
    if v[0, 0] < 0:
        v[:, 0] *= -1
    if v[0, 1] < 0:
        v[:, 1] *= -1
    proj = od @ v
    phi = np.arctan2(proj[:, 1], proj[:, 0])
    min_phi = np.percentile(phi, 100.0 - angular_percentile)
    max_phi = np.percentile(phi, angular_percentile)
    v1 = v @ np.array([np.cos(min_phi), np.sin(min_phi)])
    v2 = v @ np.array([np.cos(max_phi), np.sin(max_phi)])
    he = np.array([v1, v2]) if v1[0] > v2[0] else np.array([v2, v1])
    return he / np.linalg.norm(he, axis=1, keepdims=True)


def _concentrations(img: np.ndarray, stain_matrix: np.ndarray) -> np.ndarray:
    od = _rgb_to_od(img).reshape(-1, 3)
    # least-squares in place of staintools' sparse lasso; clipped nonnegative
    c, *_ = np.linalg.lstsq(stain_matrix.T, od.T, rcond=None)
    return np.maximum(c.T, 0.0)


class MacenkoNormalizer:
    """staintools.StainNormalizer(method='macenko')-compatible fit/transform."""

    def __init__(self):
        self.stain_matrix_target = None
        self.max_c_target = None

    def fit(self, target: np.ndarray) -> "MacenkoNormalizer":
        self.stain_matrix_target = _macenko_stain_matrix(target)
        c = _concentrations(target, self.stain_matrix_target)
        self.max_c_target = np.percentile(c, 99, axis=0)
        return self

    def transform(self, img: np.ndarray) -> np.ndarray:
        if self.stain_matrix_target is None:
            raise RuntimeError("MacenkoNormalizer.fit not called")
        sm_source = _macenko_stain_matrix(img)
        c = _concentrations(img, sm_source)
        max_c_source = np.percentile(c, 99, axis=0)
        c *= self.max_c_target / np.maximum(max_c_source, 1e-8)
        od = c @ self.stain_matrix_target
        out = 255.0 * np.exp(-od)
        return np.clip(out, 0, 255).reshape(img.shape).astype(np.uint8)
