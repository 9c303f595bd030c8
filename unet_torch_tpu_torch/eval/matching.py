"""Counting / localization matching metrics.

Capability parity with reference CrowdMatching.py, re-architected for speed:
the reference stamps a full-resolution Gaussian map per prediction per (sigma,
threshold) cell (CrowdMatching.py:162-176, O(S*T*N_pred*H*W)); the kernel value at
a GT dot is analytically exp(-d²/2σ²) (normalised by the kernel peak), so we
compute pairwise responses once per sigma and run the same greedy consume-nearest
loop in O(N_pred*N_gt).  Results are identical, including the reference's
row-major tie-break (np.where(...)[0][0], :175-176) and its 4σ kernel cutoff.

Functions:
  calculate_estimated_coordinates  contour centroids       ref :41-58
  matlab_style_gauss / inset_gaussian                      ref :63-106
  crowd_matching_test              (σ, thresh) P/R/F1 grid ref :108-189
  crowd_matching_greedy            radius-10 greedy P/R/F1 ref :270-296
                                   (the surviving second definition)
  count_accuracy_metric            abs diff / MRE / rel / RPD  ref :298-307
  gmae                             grid MAE "GAME(L)"      ref :309-331
"""

from __future__ import annotations

import numpy as np


def calculate_estimated_coordinates(pred: np.ndarray):
    """Centroids of connected components via contour moments (ref :41-58)."""
    import cv2

    contours, _ = cv2.findContours(pred.astype(np.uint8), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_NONE)
    xs, ys = [], []
    for contour in contours:
        m = cv2.moments(contour)
        if m["m00"] == 0:
            continue
        xs.append(round(m["m10"] / m["m00"]))
        ys.append(round(m["m01"] / m["m00"]))
    return np.array(xs), np.array(ys)


def matlab_style_gauss(shape=(3, 3), sigma=0.5):
    """MATLAB fspecial('gaussian') (ref :63-75)."""
    m, n = [(ss - 1.0) / 2.0 for ss in shape]
    y, x = np.ogrid[-m: m + 1, -n: n + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    s = h.sum()
    if s != 0:
        h /= s
    return h


def inset_gaussian(h_gaussian, e_coordinate, size):
    """Paste a kernel into a zero map with boundary clipping (ref :77-106)."""
    out = np.zeros(size)
    height, width = h_gaussian.shape
    cy, cx = e_coordinate
    x_start, y_start = cx - width // 2, cy - height // 2
    x_end, y_end = x_start + width, y_start + height
    xs, ys = max(0, x_start), max(0, y_start)
    xe, ye = min(size[1], x_end), min(size[0], y_end)
    hxs, hys = xs - x_start, ys - y_start
    out[ys:ye, xs:xe] = h_gaussian[hys:hys + (ye - ys), hxs:hxs + (xe - xs)]
    return out


def _pred_coords(estimation, input_type):
    if input_type == "Segmentation":
        return calculate_estimated_coordinates(estimation)
    if input_type == "Regression":
        from unet_torch_tpu_torch.eval.peaks import peak_local_max

        est = estimation.copy()
        est[est < 0.001] = 0
        coords = peak_local_max(est, min_distance=3)
        return coords[:, 1], coords[:, 0]
    if input_type == "Coordinates":
        return estimation
    raise ValueError(f"INVALID inputType {input_type!r}")


def crowd_matching_test(g_dot, estimation, sigma_list, sigma_thresh_list,
                        input_type="Segmentation"):
    """(len(sigma), len(thresh)) precision/recall/F1 grids (ref :108-189)."""
    S, T = len(sigma_list), len(sigma_thresh_list)
    arr_prec = np.zeros((S, T))
    arr_recall = np.zeros((S, T))
    arr_f1 = np.zeros((S, T))

    e_coord_x, e_coord_y = _pred_coords(estimation, input_type)
    g_count = int(np.sum(g_dot))
    if g_count == 0:
        if len(e_coord_x) == 0:
            arr_prec.fill(1)
            arr_recall.fill(1)
            arr_f1.fill(1)
        else:
            arr_recall.fill(1)
        return arr_prec, arr_recall, arr_f1

    gy, gx = np.nonzero(g_dot)
    g_order = np.arange(len(gy))  # row-major order of nonzero == tie-break order
    n_pred = len(e_coord_x)

    for s, sigma in enumerate(sigma_list):
        radius = int(round(4 * sigma))
        # integer-offset responses, normalised by the kernel peak:
        # exp(-(dy²+dx²)/2σ²), zero outside the kernel support
        dy = gy[None, :] - np.asarray(e_coord_y, np.int64)[:, None]
        dx = gx[None, :] - np.asarray(e_coord_x, np.int64)[:, None]
        resp = np.exp(-(dy.astype(np.float64) ** 2 + dx.astype(np.float64) ** 2)
                      / (2.0 * sigma * sigma))
        outside = (np.abs(dy) > radius) | (np.abs(dx) > radius)
        resp[outside] = 0.0

        for t, thresh in enumerate(sigma_thresh_list):
            consumed = np.zeros(len(gy), bool)
            tp = fp = 0
            for e in range(n_pred):
                r = np.where(consumed, 0.0, resp[e])
                best = r.max() if len(r) else 0.0
                if best < thresh or best == 0.0:
                    fp += 1
                else:
                    tp += 1
                    # reference tie-break: first row-major GT with the max value
                    cand = np.nonzero(r == best)[0]
                    consumed[cand[g_order[cand].argmin()]] = True
            fn = max(g_count - tp, 0)
            prec = tp / (tp + fp + 1e-7)
            recall = tp / (tp + fn)
            arr_prec[s, t] = prec
            arr_recall[s, t] = recall
            arr_f1[s, t] = 2 * prec * recall / (prec + recall + 1e-7)
    return arr_prec, arr_recall, arr_f1


def crowd_matching_greedy(gt_dot, pred_localization, thresh=10):
    """Euclidean greedy GT->nearest unmatched prediction (ref :270-296, the
    surviving second CrowdMatchingTest2 definition)."""
    e_coord_x, e_coord_y = pred_localization
    if len(e_coord_x) == 0:
        return 0, 0, 0
    e_coord_x = np.asarray(e_coord_x, float)
    e_coord_y = np.asarray(e_coord_y, float)
    detected = np.zeros(len(e_coord_y), bool)
    gt_y, gt_x = np.where(gt_dot != 0)
    tp = 0
    for ygt, xgt in zip(gt_y, gt_x):
        avail = ~detected
        if not avail.any():
            break
        d = np.full(len(e_coord_y), np.inf)
        d[avail] = np.sqrt((e_coord_y[avail] - ygt) ** 2
                           + (e_coord_x[avail] - xgt) ** 2)
        idx = int(np.argmin(d))
        if d[idx] < thresh:
            tp += 1
            detected[idx] = True
    prec = tp / len(detected)
    recall = tp / max(len(gt_x), 1)
    f1 = 2 * prec * recall / (prec + recall + 1e-7)
    return prec, recall, f1


def count_accuracy_metric(count_gt, count_pred):
    """abs diff, MRE, relative, RPD (ref :298-307)."""
    abs_diff = abs(count_gt - count_pred)
    accuracy = round(abs_diff / (count_gt + 1e-6), 4)
    accuracy_relative = round(abs_diff / (max(count_gt, count_pred) + 1e-6), 4)
    accuracy_rpd = round((2 * abs_diff) / (count_gt + count_pred + 1e-6), 4)
    return abs_diff, accuracy, accuracy_relative, accuracy_rpd


def gmae(L, gt_img, pred_img, img_size=512):
    """GAME(L): sum of per-cell count errors over a 2^L x 2^L grid
    (ref :309-331; test_reg3serousv5mt.py:153-184 overrides with 768)."""
    cell = img_size // (2 ** L)
    g_abs = g_rel = g_rpd = 0
    for i in range(0, img_size, cell):
        for j in range(0, img_size, cell):
            cgt = int(np.sum(gt_img[i:i + cell, j:j + cell]))
            cpr = int(np.sum(pred_img[i:i + cell, j:j + cell]))
            abs_diff, _, rel, rpd = count_accuracy_metric(cgt, cpr)
            g_abs += abs_diff
            g_rel += rel
            g_rpd += rpd
    return [g_abs, g_rel, g_rpd]
