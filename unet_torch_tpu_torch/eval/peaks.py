"""Local-maxima detection — skimage.feature.peak_local_max equivalent.

The reference localises density-map predictions with peak_local_max(min_distance=3)
(reference CrowdMatching.py:116-120); skimage is not in this image, so this
is a from-scratch implementation: maximum-filter candidate detection followed by
intensity-ordered min-distance suppression (the same algorithm skimage uses).
"""

from __future__ import annotations

import numpy as np


def peak_local_max(image: np.ndarray, min_distance: int = 1,
                   threshold_abs: float | None = None,
                   exclude_border: bool = True) -> np.ndarray:
    """Returns (N, 2) array of [row, col] peak coordinates.

    Matches skimage.feature.peak_local_max defaults: candidate maxima from a
    (2*min_distance+1) square maximum filter, peaks within ``min_distance``
    of the border excluded (``exclude_border=True`` semantics), then
    intensity-ordered greedy spacing enforcement under the CHEBYSHEV norm
    (skimage's ``p_norm=np.inf`` default) where a suppressed candidate never
    suppresses others (ensure_spacing semantics)."""
    from scipy import ndimage

    if threshold_abs is None:
        threshold_abs = float(image.min())
    size = 2 * min_distance + 1
    maxed = ndimage.maximum_filter(image, size=size, mode="constant")
    mask = (image == maxed) & (image > threshold_abs)
    if exclude_border and min_distance > 0:
        border = np.zeros_like(mask)
        border[min_distance:-min_distance or None,
               min_distance:-min_distance or None] = True
        mask &= border
    coords = np.argwhere(mask)
    if len(coords) == 0:
        return coords.reshape(0, 2)
    # intensity-ordered spacing enforcement
    intensities = image[tuple(coords.T)]
    order = np.argsort(-intensities, kind="stable")
    coords = coords[order]
    from scipy.spatial import cKDTree

    accepted = np.zeros(len(coords), bool)
    tree = cKDTree(coords)
    suppressed = np.zeros(len(coords), bool)
    for i in range(len(coords)):
        if suppressed[i]:
            continue
        accepted[i] = True
        for j in tree.query_ball_point(coords[i], r=min_distance,
                                       p=np.inf):
            if j != i:
                suppressed[j] = True
    return coords[accepted]
