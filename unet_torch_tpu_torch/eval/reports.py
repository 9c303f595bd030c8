"""Eval entry points (counterpart of unet_torch_tpu/eval/reports.py).

The report accumulators (Results2Class, Results3Class) and the eval
preprocess are the JAX package's own, imported as they are: they are numpy
and cv2 code. What is ported is the model side: `make_predict_fn`, the
batched eval loop and `test_single_mc`. The reused pieces are imported where
they are used, so `make_predict_fn` loads nothing of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from unet_torch_tpu_torch.eval.metrics import class_argmax


def make_predict_fn(model, device, dtype, classes: bool = False):
    """Eval forward on `device` in `dtype`: NHWC float32 numpy batch in,
    device tensor out (logits, or a uint8 class map with classes=True).

    Returns as soon as the work is queued on the device; reading the result
    on the host is the sync point."""
    model = model.to(device).eval()

    @torch.inference_mode()
    def predict(xs: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(xs).to(device=device, dtype=dtype,
                                    non_blocking=True)
        out = model(x)
        return class_argmax(out) if classes else out

    return predict


def _batched_eval(image_list, ch, input_size, predict, chunk: int = 8):
    """Decode + preprocess a chunk of eval images, run one batched forward,
    yield (paths, originals, outputs). The last chunk is padded to `chunk`
    and the padding dropped.

    One-deep pipeline: chunk k's forward is queued before chunk k-1's result
    is copied to the host, so the device computes chunk k while the host
    decodes chunk k+1 and postprocesses chunk k-1."""
    from unet_torch_tpu.eval.reports import _load_eval_image, preprocess_eval

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
            yield paths, originals, outs[:n].cpu().numpy()
        prev = cur
    if prev is not None:
        paths, originals, n, outs = prev
        yield paths, originals, outs[:n].cpu().numpy()


def test_single_mc(model, device, dtype, input_size, ch, num_class,
                   image_list, save_dir):
    """Multi-class segmentation eval (ref test_mc3serousv5.py:859-900):
    argmax -> zoom back -> compare against *_label_mc.png/*_gt_dot_mc.png."""
    import cv2

    from unet_torch_tpu.data.io import zoom_resize
    from unet_torch_tpu.eval.reports import Results2Class, Results3Class

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
