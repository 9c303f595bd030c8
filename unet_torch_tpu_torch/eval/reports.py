"""Eval entry points (counterpart of the model side of
unet_torch_tpu/eval/reports.py): `make_predict_fn`, the batched eval loop and
the suites `test_single_mc`, `test_single`, `test_single_crop`,
`test_single_reg` and `test_multiple_reg`. The report accumulators and the
eval preprocess are in eval/results.py, numpy and cv2 code; cv2 is imported
where it is used.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from unet_torch_tpu_torch.data.io import (
    to_model_input,
    z_normalize,
    zoom_resize,
)
from unet_torch_tpu_torch.eval.metrics import class_argmax
from unet_torch_tpu_torch.eval.results import (
    Results2Class,
    Results3Class,
    ResultsCC,
    TwoChannelRegResults,
    _gt_dots_for,
    _load_eval_image,
    preprocess_eval,
)


def sigmoid_mask(logits):
    """The binary suites' postprocess on the device: channel 0 of the logits
    through the sigmoid (in f32), 1 where it reaches 0.5, as uint8."""
    x = logits[..., 0].float()
    return (1.0 / (1.0 + torch.exp(-x)) >= 0.5).to(torch.uint8)


def make_predict_fn(model, device, dtype, classes: bool = False,
                    binary: bool = False):
    """Eval forward on `device` in `dtype`: NHWC float32 numpy batch in,
    device tensor out: logits (a tuple of them for a two-headed model), a
    uint8 class map with classes=True, or a uint8 sigmoid-threshold mask
    with binary=True.

    Returns as soon as the work is queued on the device; reading the result
    on the host is the sync point."""
    model = model.to(device).eval()

    @torch.inference_mode()
    def predict(xs: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(xs).to(device=device, dtype=dtype,
                                    non_blocking=True)
        out = model(x)
        if classes:
            return class_argmax(out)
        return sigmoid_mask(out) if binary else out

    return predict


def _batched_eval(image_list, ch, input_size, predict, chunk: int = 8):
    """Decode + preprocess a chunk of eval images, run one batched forward,
    yield (paths, originals, outputs). The last chunk is padded to `chunk`
    and the padding dropped.

    One-deep pipeline: chunk k's forward is queued before chunk k-1's result
    is copied to the host, so the device computes chunk k while the host
    decodes chunk k+1 and postprocesses chunk k-1."""
    def _load_and_dispatch(s):
        paths = image_list[s:s + chunk]
        originals = [_load_eval_image(p, ch) for p in paths]
        xs = np.concatenate([preprocess_eval(im, input_size)
                             for im in originals]).astype(np.float32)
        n = len(xs)
        if n < chunk:
            xs = np.concatenate([xs, np.repeat(xs[-1:], chunk - n, axis=0)])
        return paths, originals, n, predict(xs)

    prev = None
    for s in range(0, len(image_list), chunk):
        cur = _load_and_dispatch(s)
        if prev is not None:
            paths, originals, n, outs = prev
            yield paths, originals, _to_host(outs[:n])
        prev = cur
    if prev is not None:
        paths, originals, n, outs = prev
        yield paths, originals, _to_host(outs[:n])


def _to_host(t: torch.Tensor) -> np.ndarray:
    """The sync point: a device result as numpy, floats as f32."""
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def test_single_mc(model, device, dtype, input_size, ch, num_class,
                   image_list, save_dir):
    """Multi-class segmentation eval (ref test_mc3serousv5.py:859-900):
    argmax -> zoom back -> compare against *_label_mc.png/*_gt_dot_mc.png."""
    import cv2

    os.makedirs(save_dir, exist_ok=True)
    if num_class == 3:
        res = Results2Class(save_dir, True)
    elif num_class == 4:
        res = Results3Class(save_dir)
    else:
        raise ValueError(f"invalid Num_Class {num_class} for test_single_mc")

    predict = make_predict_fn(model, device, dtype, classes=True)
    for paths, originals, outs in _batched_eval(image_list, ch, input_size,
                                                predict):
        for img_path, img_org, out in zip(paths, originals, outs):
            h, w = img_org.shape[:2]
            pred = out
            if (h, w) != tuple(input_size):
                pred = zoom_resize(pred, h, w, order=0)
            pred = np.uint8(pred)

            label = cv2.imread(img_path.replace(".png", "_label_mc.png"), 0)
            gt_dot_path = img_path.replace(".png", "_gt_dot_mc.png")
            if not os.path.exists(gt_dot_path):
                gt_dot_path = img_path.replace(".png", "_gt_dot.png")
            gt_dot = cv2.imread(gt_dot_path, 0)
            res.imageNames.append(os.path.basename(img_path))
            if num_class == 3:
                res.compare_images(img_org, label, pred, gt_dot)
            else:
                res.compare_images(img_org, label, pred)
    res.save()
    return res.get_results()


def test_single(model, device, dtype, input_size, ch, num_class, image_list,
                save_dir):
    """Binary sigmoid-threshold eval: sigmoid -> 0.5 binarise (on the
    device) -> zoom back -> ResultsCC against *_label.png and
    *_gt_dot.png."""
    import cv2

    os.makedirs(save_dir, exist_ok=True)
    res = ResultsCC(save_dir, True)
    predict = make_predict_fn(model, device, dtype, binary=True)
    for paths, originals, outs in _batched_eval(image_list, ch, input_size,
                                                predict):
        for img_path, img_org, pred in zip(paths, originals, outs):
            res.imageNames.append(os.path.basename(img_path))
            h, w = img_org.shape[:2]
            if (h, w) != tuple(input_size):
                pred = zoom_resize(pred, h, w, order=0).astype(np.uint8)
            mask = cv2.imread(img_path[: img_path.rfind(".")] +
                              "_label.png", 0)
            gt_dot = cv2.imread(img_path.replace(".png", "_gt_dot.png"), 0)
            res.compare_images(img_org, mask, pred, gt_dot)
    res.save()
    return res.get_results()


def test_single_crop(model, device, dtype, input_size, ch, num_class,
                     crop_size, image_list, save_dir):
    """Tiled binary eval: centre-pad to a multiple of the crop, predict per
    tile in fixed chunks of 16 tiles (the last one padded, the padding
    dropped), stitch, ResultsCC. One-deep pipeline: chunk k runs on the
    device while chunk k-1's masks are copied back and written."""
    import cv2

    os.makedirs(save_dir, exist_ok=True)
    res = ResultsCC(save_dir, True)
    predict = make_predict_fn(model, device, dtype, binary=True)
    chunk = 16
    for img_path in image_list:
        res.imageNames.append(os.path.basename(img_path))
        img_org = _load_eval_image(img_path, ch)
        label = cv2.imread(img_path.replace(".png", "_label.png"), 0)
        gt_dot = cv2.imread(img_path.replace(".png", "_gt_dot.png"), 0)

        pad_h = (-img_org.shape[0]) % crop_size
        pad_w = (-img_org.shape[1]) % crop_size
        pads = ((pad_h // 2, pad_h - pad_h // 2),
                (pad_w // 2, pad_w - pad_w // 2))
        label = np.pad(label, pads)
        gt_dot = np.pad(gt_dot, pads)
        img = np.pad(img_org, pads + ((0, 0),) * (img_org.ndim - 2),
                     constant_values=255)
        img = to_model_input(z_normalize(img.astype(np.float64)))

        coords = [(i, j) for i in range(0, img.shape[0], crop_size)
                  for j in range(0, img.shape[1], crop_size)]
        tiles = np.stack([img[i:i + crop_size, j:j + crop_size]
                          for i, j in coords]).astype(np.float32)
        pred = np.zeros(label.shape, np.uint8)

        def _dispatch(s):
            batch = tiles[s:s + chunk]
            n = len(batch)
            if n < chunk:
                batch = np.concatenate(
                    [batch, np.repeat(batch[-1:], chunk - n, axis=0)])
            return s, n, predict(batch)

        def _write_back(s, n, masks):
            for (i, j), o in zip(coords[s:s + chunk], _to_host(masks[:n])):
                pred[i:i + crop_size, j:j + crop_size] = o

        prev = None
        for s in range(0, len(tiles), chunk):
            cur = _dispatch(s)
            if prev is not None:
                _write_back(*prev)
            prev = cur
        if prev is not None:
            _write_back(*prev)
        res.compare_images(img_org, label, pred, gt_dot)
    res.save()
    return res.get_results()


def _two_channel_reg(predict, input_size, ch, image_list, save_dir,
                     tsv_files):
    """The density-regression suite on a predict that returns (B, H, W, C)
    with channels [other, immune]: ReLU -> zoom back -> / 200 -> counts
    against the dot maps, ratio, GAME, sigma-grid matching."""
    os.makedirs(save_dir, exist_ok=True)
    res = TwoChannelRegResults(save_dir)
    for paths, originals, outs in _batched_eval(image_list, ch, input_size,
                                                predict):
        for img_path, img_org, out in zip(paths, originals, outs):
            res.sample_list.append(os.path.basename(img_path))
            h, w = img_org.shape[:2]
            out = np.maximum(out, 0)
            pred_other = out[..., 0]
            pred_immune = out[..., 1] if out.shape[-1] > 1 else \
                np.zeros_like(pred_other)
            if (h, w) != tuple(input_size):
                pred_other = zoom_resize(pred_other, h, w, order=0)
                pred_immune = zoom_resize(pred_immune, h, w, order=0)
            dot_other, dot_immune = _gt_dots_for(img_path, tsv_files, (h, w))
            res.add(pred_other / 200.0, pred_immune / 200.0, dot_other,
                    dot_immune)
    res.save()
    return res.get_results()


def test_single_reg(model, device, dtype, input_size, ch, num_class,
                    image_list, save_dir, tsv_files=None):
    """Two-channel density regression eval: the model's channels are
    [other, immune]."""
    predict = make_predict_fn(model, device, dtype)
    return _two_channel_reg(predict, input_size, ch, image_list, save_dir,
                            tsv_files)


def test_multiple_reg(model, device, dtype, input_size, ch, num_class,
                      image_list, save_dir, tsv_files=None):
    """Two-head density regression eval: the same suite on the heads
    (immune, other) of the multitask model."""
    predict = make_predict_fn(model, device, dtype)

    def predict_pair(x):
        o_immune, o_other = predict(x)
        return torch.stack([o_other[..., 0], o_immune[..., 0]], dim=-1)

    return _two_channel_reg(predict_pair, input_size, ch, image_list,
                            save_dir, tsv_files)
