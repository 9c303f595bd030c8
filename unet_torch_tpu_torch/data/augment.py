"""Host-side augmentation — numpy/cv2 implementations of the reference's ops.

The reference mixes three stacks (imgaug, torchio, torchvision ColorJitter —
DataLoader.py:246-271,444-470); none of those exist in this image, so the ops in
active use are re-implemented directly:

  * random_rot_flip / random_rotate (DataLoader.py:103-120) — the 50/50 pipeline
    applied by Data_Binary/Data_Reg/DataPointReg/DataRandomCrop (:286-290 etc.)
  * the heatmap-aware pathology pipeline of Data_Reg_MT (:477-486): p=0.75 of
    [SomeOf(0..2): affine rotate ±40, translate ±40px, fliplr, flipud,
    rot90/180/270, blur/median/sharpen] followed by ColorJitter(0.25,0.25,0.25,
    0.01); geometric ops are applied identically to image and heatmaps.
  * pad_image random-offset zero/255 padding (DataLoader.py:27-47)

All functions take an explicit np.random.RandomState so augmentation is
reproducible per seed (the reference uses global `random`).
"""

from __future__ import annotations

import numpy as np


def random_rot_flip(samples, rng: np.random.RandomState):
    """DataLoader.py:103-111 — shared k-rot90 + axis flip across all samples."""
    k = rng.randint(0, 4)
    axis = rng.randint(0, 2)
    return [np.flip(np.rot90(s, k), axis=axis).copy() for s in samples]


def random_rotate(samples, rng: np.random.RandomState):
    """DataLoader.py:114-120 — shared ±20° rotation, nearest-neighbour, no
    reshape.  Implemented with cv2.warpAffine (same centre rotation + zero
    fill as ndimage.rotate(order=0), much faster: the rotate path dominated
    the warm input-pipeline cost)."""
    import cv2

    angle = rng.randint(-20, 20)
    outs = []
    for s in samples:
        if s.ndim == 3 and s.shape[2] > 4:
            from scipy import ndimage

            outs.append(ndimage.rotate(s, angle, order=0, reshape=False))
            continue
        h, w = s.shape[:2]
        # same centre ((h-1)/2,(w-1)/2) and angle convention as
        # ndimage.rotate (verified on dot fixtures)
        mat = cv2.getRotationMatrix2D(((w - 1) / 2.0, (h - 1) / 2.0),
                                      angle, 1.0)
        out = cv2.warpAffine(s, mat, (w, h), flags=cv2.INTER_NEAREST,
                             borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        outs.append(out.reshape(s.shape))
    return outs


def basic_geometric(samples, rng: np.random.RandomState):
    """The 50%/25% rot-flip-else-rotate pipeline (DataLoader.py:286-290)."""
    if rng.random_sample() > 0.5:
        return random_rot_flip(samples, rng)
    if rng.random_sample() > 0.5:
        return random_rotate(samples, rng)
    return list(samples)


def pad_image(samples, padding_w: int, padding_h: int,
              rng: np.random.RandomState):
    """DataLoader.py:27-47 — random split of the padding; 2D arrays pad with 0,
    3D (colour) pad with 255."""
    pad_left = rng.randint(0, padding_w + 1) if padding_w else 0
    pad_right = padding_w - pad_left
    pad_top = rng.randint(0, padding_h + 1) if padding_h else 0
    pad_bottom = padding_h - pad_top
    outs = []
    for img in samples:
        if img.ndim == 2:
            outs.append(np.pad(img, ((pad_top, pad_bottom),
                                     (pad_left, pad_right)),
                               mode="constant", constant_values=0))
        else:
            outs.append(np.pad(img, ((pad_top, pad_bottom),
                                     (pad_left, pad_right), (0, 0)),
                               mode="constant", constant_values=255))
    return outs


# ---------------------------------------------------------------------------
# colour jitter (torchvision ColorJitter(brightness/contrast/saturation/hue))
# ---------------------------------------------------------------------------

def color_jitter(img: np.ndarray, rng: np.random.RandomState,
                 brightness: float = 0.25, contrast: float = 0.25,
                 saturation: float = 0.25, hue: float = 0.01) -> np.ndarray:
    """uint8 RGB jitter with torchvision-style uniform factor sampling."""
    import cv2

    out = img.astype(np.float32)
    ops = []
    if brightness:
        f = rng.uniform(1 - brightness, 1 + brightness)
        ops.append(lambda x: x * f)
    if contrast:
        f = rng.uniform(1 - contrast, 1 + contrast)
        ops.append(lambda x: (x - x.mean()) * f + x.mean())
    if saturation:
        f = rng.uniform(1 - saturation, 1 + saturation)

        def sat(x, f=f):
            gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
            return gray[..., None] + (x - gray[..., None]) * f

        ops.append(sat)
    rng.shuffle(ops)
    for op in ops:
        out = op(out)
    out = np.clip(out, 0, 255).astype(np.uint8)
    if hue:
        shift = rng.uniform(-hue, hue) * 180.0  # cv2 hue range 0..180
        hsv = cv2.cvtColor(out, cv2.COLOR_RGB2HSV)
        hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(round(shift))) % 180
        out = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
    return out


# ---------------------------------------------------------------------------
# heatmap-aware pathology pipeline (Data_Reg_MT, DataLoader.py:446-486)
# ---------------------------------------------------------------------------

def _affine(img, mat, out_shape, border_value, interp):
    import cv2

    return cv2.warpAffine(img, mat, (out_shape[1], out_shape[0]),
                          flags=interp, borderMode=cv2.BORDER_CONSTANT,
                          borderValue=border_value)


def pathology_augment_hm(image: np.ndarray, heatmaps, rng: np.random.RandomState):
    """SomeOf((0,2)) of the reference's imgaug ops, applied jointly to the RGB
    image (cval 255, cubic) and each heatmap (cval 0, nearest), then
    ColorJitter on the image only.  Returns (image, [heatmaps...])."""
    import cv2

    h, w = image.shape[:2]
    heatmaps = [np.asarray(m, np.float32) for m in heatmaps]

    def apply_geom(mat):
        nonlocal image, heatmaps
        image = _affine(image, mat, (h, w), (255, 255, 255), cv2.INTER_CUBIC)
        heatmaps = [_affine(m, mat, (h, w), 0, cv2.INTER_NEAREST)
                    for m in heatmaps]

    def op_rotate():
        ang = rng.uniform(-40, 40)
        apply_geom(cv2.getRotationMatrix2D((w / 2, h / 2), ang, 1.0))

    def op_translate():
        tx, ty = rng.randint(-40, 41), rng.randint(-40, 41)
        apply_geom(np.array([[1, 0, tx], [0, 1, ty]], np.float32))

    def op_fliplr():
        nonlocal image, heatmaps
        image = image[:, ::-1].copy()
        heatmaps = [m[:, ::-1].copy() for m in heatmaps]

    def op_flipud():
        nonlocal image, heatmaps
        image = image[::-1].copy()
        heatmaps = [m[::-1].copy() for m in heatmaps]

    def op_rot90():
        nonlocal image, heatmaps
        k = rng.choice([1, 2, 3])
        image = np.rot90(image, k).copy()
        heatmaps = [np.rot90(m, k).copy() for m in heatmaps]
        # non-square images change shape; geometric ops afterwards use new dims

    def op_photometric():
        nonlocal image
        choice = rng.randint(0, 3)
        if choice == 0:
            sigma = rng.uniform(0.1, 0.25)
            image = cv2.GaussianBlur(image, (3, 3), sigma)
        elif choice == 1:
            image = cv2.medianBlur(image.astype(np.uint8), 3)
        else:
            alpha = rng.uniform(0.0, 0.3)
            light = rng.uniform(0.8, 1.2)
            blur = cv2.GaussianBlur(image, (3, 3), 1.0)
            sharp = np.clip(image.astype(np.float32) * (1 + alpha) * light
                            - blur.astype(np.float32) * alpha, 0, 255)
            image = sharp.astype(image.dtype)

    ops = [op_rotate, op_translate, op_fliplr, op_flipud, op_rot90,
           op_photometric]
    n = rng.randint(0, 3)
    for idx in rng.choice(len(ops), size=n, replace=False):
        ops[int(idx)]()

    if image.ndim == 3:
        image = color_jitter(image.astype(np.uint8), rng)
    return image, heatmaps
