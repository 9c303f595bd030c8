"""Dataset classes — capability parity with reference DataLoader.py's six
torch Datasets, emitting HWC numpy instead of CHW tensors (the port's own
copy of the JAX package's data/datasets.py).

Sample contracts (SURVEY.md §2.2):
  Data_Binary      (image f32 (H,W,C), label int64 (H,W))            ref :617-731
  Data_Reg         (image, density*200 (H,W,C_lab))                  ref :230-420
  Data_Reg_MT      (image, (immune*200, other*200))                  ref :422-615
  Data_Reg_Binary  (image, (binary mask, reg map*200))               ref :122-228
                   (reference class has latent bugs :148-155,181 — this one works)
  DataPointReg     train: ([patch], [target dict]); val: (patches, dot patches)
                                                                      ref :733-926
  DataRandomCrop   train: random crop triple; val: pad + tile triple  ref :928-1069

Label-file conventions preserved exactly: `X_label_mc.png` + `X_gt_dot.png`,
`X_label_reg.npy`, `X_label_immune_reg.npy`/`X_label_other_reg.npy`,
`X_label.png`, per-image `.tsv` point annotations with x,y halved
(ref :866-893).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from unet_torch_tpu_torch.data.augment import (
    basic_geometric,
    pad_image,
    pathology_augment_hm,
)
from unet_torch_tpu_torch.data.io import (
    decode_image,
    get_image_list,
    to_model_input,
    z_normalize,
    zoom_resize,
)


def _nbytes(val) -> int:
    if isinstance(val, np.ndarray):
        return int(val.nbytes)
    if isinstance(val, (tuple, list)):
        return sum(_nbytes(v) for v in val)
    if isinstance(val, dict):
        return sum(_nbytes(v) for v in val.values())
    return 64  # scalars / None


class _Base:
    """Shared decode/normalise plumbing plus a bounded in-memory sample cache.

    The reference re-decodes and re-zooms every image every epoch
    (DataLoader.py:346-360 run inside __getitem__).  The input pipeline must
    outrun the device, and cv2-decode + order-3 scipy zoom is slow on one
    core, so decoded (and, when
    augmentation is off, fully preprocessed) samples are memoised up to
    ``cache_bytes``.  Augmented samples are never cached — only the
    deterministic work feeding them.
    """

    def __init__(self, data_path, ch, anydepth=False, augmentation=False,
                 input_size=(512, 512), seed=0, normalizer=None,
                 exclude=("_label", "_gt_dot"), cache_bytes=2 << 30):
        self.image_list = get_image_list(data_path, exclude=exclude)
        self.channel = ch
        self.anydepth = anydepth
        self.augmentation = augmentation
        self.height, self.width = input_size
        self.rng = np.random.RandomState(seed)
        self.normalizer = normalizer
        self._cache = {}
        self._cache_used = 0
        self._cache_limit = int(cache_bytes)
        import threading

        self._rng_lock = threading.Lock()
        if ch == -2 and normalizer is None:
            raise ValueError("channel=-2 needs a fitted MacenkoNormalizer "
                             "(reference fits on a hardcoded tile, "
                             "DataLoader.py:240)")

    def __len__(self):
        return len(self.image_list)

    def _cached(self, key, fn):
        """Memoise fn() under key, bounded by the byte budget.  Thread-safe
        enough for the prefetch/worker threads (worst case: duplicate work)."""
        if self._cache_limit <= 0:
            return fn()
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        val = fn()
        size = _nbytes(val)
        if self._cache_used + size <= self._cache_limit:
            self._cache[key] = val
            self._cache_used += size
        return val

    def _local_rng(self) -> np.random.RandomState:
        """Per-call child RNG: np.random.RandomState is not thread-safe, and
        __getitem__ runs concurrently under NumpyLoader num_workers — draw a
        child seed under a lock, do all randomness on the child."""
        with self._rng_lock:
            seed = int(self.rng.randint(0, 2 ** 31 - 1))
        return np.random.RandomState(seed)

    def _decode(self, img_path):
        return decode_image(img_path, self.channel, self.anydepth,
                            self.normalizer)

    def _finalize_image(self, image):
        image = z_normalize(np.asarray(image, np.float32))
        return to_model_input(image)


class DataBinary(_Base):
    """Binary/multi-class masks + dot maps (ref Data_Binary :617-731).

    The reference computes the dot map but drops it (:679,:709);
    ``return_gt_dot=True`` yields the (image, label, gt_dot) triple that the
    topo warm-up trainer consumes (Trainer.py:325)."""

    def __init__(self, *args, return_gt_dot: bool = False, **kw):
        super().__init__(*args, **kw)
        self.return_gt_dot = return_gt_dot

    def _raw(self, idx):
        img_path = self.image_list[idx]

        def load():
            import cv2

            image = self._decode(img_path)
            label = cv2.imread(img_path.replace(".png", "_label_mc.png"), 0)
            gt_dot = cv2.imread(img_path.replace(".png", "_gt_dot.png"), 0)
            return image, label, gt_dot

        return self._cached(("raw", idx), load)

    def __getitem__(self, idx):
        if not self.augmentation:
            return self._cached(("final", idx), lambda: self._build(idx))
        return self._build(idx)

    def _build(self, idx):
        image, label, gt_dot = self._raw(idx)
        if self.augmentation:
            image, label, gt_dot = basic_geometric([image, label, gt_dot],
                                                   self._local_rng())
        image = zoom_resize(image, self.height, self.width, order=3)
        label = zoom_resize(label, self.height, self.width, order=0)
        if self.return_gt_dot:
            gt_dot = zoom_resize(gt_dot, self.height, self.width, order=0)
            return (self._finalize_image(image), np.asarray(label, np.int32),
                    np.asarray(gt_dot, np.float32))
        return (self._finalize_image(image),
                np.asarray(label, np.int32))


class DataReg(_Base):
    """Density regression, labels scaled x200 (ref Data_Reg :230-420).

    The reference *constructs* imgaug/torchio/ColorJitter photometric stacks
    for Data_Reg but its active transform applies only the geometric 50/25
    rot-flip/rotate (the photometric block is commented out,
    DataLoader.py:285-303) — so the default here is geometric-only.
    ``photometric=True`` opts into the heatmap-aware pipeline the reference
    gestures at (same ops Data_Reg_MT actually uses, :477-486).
    """

    def __init__(self, *args, photometric: bool = False, **kw):
        super().__init__(*args, **kw)
        self.photometric = photometric

    def __getitem__(self, idx):
        if not self.augmentation:
            return self._cached(("final", idx), lambda: self._build(idx))
        return self._build(idx)

    def _build(self, idx):
        img_path = self.image_list[idx]

        def load():
            image = self._decode(img_path)
            label = np.load(img_path[: img_path.rfind(".")] +
                            "_label_reg.npy").astype(np.float32)
            return image, label

        image, label = self._cached(("raw", idx), load)
        if self.augmentation:
            rng = self._local_rng()
            image, label = basic_geometric([image, label], rng)
            if self.photometric and rng.random_sample() > 0.25:
                hm = [label] if label.ndim == 2 else \
                    [label[:, :, i] for i in range(label.shape[2])]
                image, hm = pathology_augment_hm(image, hm, rng)
                label = hm[0] if len(hm) == 1 else np.stack(hm, axis=-1)
        image = zoom_resize(image, self.height, self.width, order=3)
        label = zoom_resize(label, self.height, self.width, order=0)
        if label.ndim == 2:
            label = label[:, :, None]
        return self._finalize_image(image), label * 200.0


class DataRegMT(_Base):
    """Two density maps (immune/other), x200, heatmap-aware augmentation with
    p=0.75 (ref Data_Reg_MT :422-615, aug at :477-486)."""

    def __getitem__(self, idx):
        if not self.augmentation:
            return self._cached(("final", idx), lambda: self._build(idx))
        return self._build(idx)

    def _build(self, idx):
        img_path = self.image_list[idx]

        def load():
            image = self._decode(img_path)
            stem = img_path[: img_path.rfind(".")]
            immune = np.load(stem + "_label_immune_reg.npy").astype(
                np.float32)
            other = np.load(stem + "_label_other_reg.npy").astype(np.float32)
            return image, immune, other

        image, immune, other = self._cached(("raw", idx), load)
        if self.augmentation:
            rng = self._local_rng()
            if rng.random_sample() > 0.25:
                image, (immune, other) = pathology_augment_hm(
                    image, [immune, other], rng)
        image = zoom_resize(image, self.height, self.width, order=3)
        immune = zoom_resize(immune, self.height, self.width, order=0)
        other = zoom_resize(other, self.height, self.width, order=0)
        return (self._finalize_image(image),
                (immune * 200.0, other * 200.0))


class DataRegBinary(_Base):
    """Joint binary mask + regression map (ref Data_Reg_Binary :122-228; the
    reference class references undefined label1/label2 — fixed here)."""

    def __getitem__(self, idx):
        if not self.augmentation:
            return self._cached(("final", idx), lambda: self._build(idx))
        return self._build(idx)

    def _build(self, idx):
        img_path = self.image_list[idx]

        def load():
            import cv2

            image = self._decode(img_path)
            mask = cv2.imread(img_path.replace(".png", "_label.png"), 0)
            reg = np.load(img_path[: img_path.rfind(".")] +
                          "_label_reg.npy").astype(np.float32)
            return image, mask, reg

        image, mask, reg = self._cached(("raw", idx), load)
        if self.augmentation:
            image, mask, reg = basic_geometric([image, mask, reg],
                                               self._local_rng())
        image = zoom_resize(image, self.height, self.width, order=3)
        mask = zoom_resize(mask, self.height, self.width, order=0)
        reg = zoom_resize(reg, self.height, self.width, order=0)
        return (self._finalize_image(image),
                (np.asarray(mask, np.float32), reg * 200.0))


class DataRandomCrop(_Base):
    """Random-crop training / pad-and-tile validation (ref :928-1069)."""

    def __init__(self, data_path, ch, anydepth=False, augmentation=False,
                 train=True, crop_size=256, seed=0, normalizer=None):
        super().__init__(data_path, ch, anydepth, augmentation,
                         input_size=(crop_size, crop_size), seed=seed,
                         normalizer=normalizer)
        self.train = train
        self.crop_size = crop_size

    def _crop(self, img, label, gt_dot, rng):
        r = rng.randint(0, img.shape[0] - self.crop_size + 1)
        c = rng.randint(0, img.shape[1] - self.crop_size + 1)
        sl = np.s_[r: r + self.crop_size, c: c + self.crop_size]
        return img[sl], label[sl], gt_dot[sl]

    def __getitem__(self, idx):
        img_path = self.image_list[idx]

        def load():
            import cv2

            image = self._decode(img_path)
            label = cv2.imread(img_path.replace(".png", "_label.png"), 0)
            gt_dot = cv2.imread(img_path.replace(".png", "_gt_dot.png"), 0)
            return image, label, gt_dot

        # decode once per image; crops/tiles are cheap views of the cached
        # full-resolution arrays (the reference re-decodes per crop)
        image, label, gt_dot = self._cached(("raw", idx), load)

        if self.train:
            rng = self._local_rng()
            image, label, gt_dot = self._crop(image, label, gt_dot, rng)
            if self.augmentation:
                image, label, gt_dot = basic_geometric(
                    [image, label, gt_dot], rng)
            return (self._finalize_image(image),
                    np.asarray(label, np.int32),
                    np.asarray(gt_dot, np.float32))

        pad_h = (-image.shape[0]) % self.crop_size
        pad_w = (-image.shape[1]) % self.crop_size
        image, label, gt_dot = pad_image([image, label, gt_dot], pad_w, pad_h,
                                         self._local_rng())
        image = self._finalize_image(image)
        cs = self.crop_size
        tiles_i, tiles_l, tiles_d = [], [], []
        for i in range(0, image.shape[0], cs):
            for j in range(0, image.shape[1], cs):
                tiles_i.append(image[i:i + cs, j:j + cs])
                tiles_l.append(label[i:i + cs, j:j + cs])
                tiles_d.append(gt_dot[i:i + cs, j:j + cs])
        return (np.stack(tiles_i), np.stack(tiles_l).astype(np.int32),
                np.stack(tiles_d).astype(np.float32))


class DataPointReg(_Base):
    """Point annotations for CLTR (ref :733-926): train returns a random
    crop_size crop plus a target dict with labels / points_macher
    (y, x, knn-dist)/crop_size / points; val tiles the full image."""

    def __init__(self, data_path, point_files, ch, anydepth=False,
                 augmentation=False, crop_size=256, num_knn=4, train=True,
                 seed=0, normalizer=None, dot_shape=(768, 768)):
        super().__init__(data_path, ch, anydepth, augmentation,
                         input_size=(crop_size, crop_size), seed=seed,
                         normalizer=normalizer, exclude=("_label",))
        self.point_files = point_files
        self.crop_size = crop_size
        self.num_knn = num_knn
        self.train = train
        self.dot_shape = dot_shape

    def create_label_coordinates(self, tsv_path):
        """Dot map from TSV (cols x, y, class) with x,y halved (ref :866-893).

        Parsed with plain Python, not pandas: this runs inside the prefetch
        thread and pandas' pyarrow string path is not thread-safe here.
        """
        img_label = np.zeros(self.dot_shape, np.float64)
        with open(tsv_path) as f:
            header = f.readline().rstrip("\n").split("\t")
            xi, yi = header.index("x"), header.index("y")
            for line in f:
                cols = line.rstrip("\n").split("\t")
                if len(cols) <= max(xi, yi) or not cols[xi]:
                    continue
                x = int(np.rint(float(cols[xi]) / 2)) - 1
                y = int(np.rint(float(cols[yi]) / 2)) - 1
                x = min(max(x, 0), img_label.shape[1] - 1)
                y = min(max(y, 0), img_label.shape[0] - 1)
                img_label[y, x] = 1
        return img_label

    def knn_distances(self, points: np.ndarray) -> np.ndarray:
        """Mean distance to the k nearest neighbours per point (ref :895-926)."""
        from scipy.spatial import cKDTree

        n = len(points)
        if n == 0:
            return np.zeros((0, 1))
        if n == 1:
            return np.zeros((1, 1))
        tree = cKDTree(points, leafsize=2048)
        k = min(self.num_knn, n)
        dist, _ = tree.query(points, k=k)
        dist = dist[:, 1:]  # drop self
        return dist.mean(axis=1, keepdims=True)

    def __getitem__(self, idx):
        img_path = self.image_list[idx]

        def load():
            image = self._decode(img_path)
            img_name = os.path.basename(img_path).split(".png")[0]
            gt_dot = self.create_label_coordinates(
                self.point_files[img_name])
            return image, gt_dot

        if self.augmentation:
            image, gt_dot = self._cached(("raw", idx), load)
            image, gt_dot = basic_geometric([image, gt_dot],
                                            self._local_rng())
            image = self._finalize_image(image)
        else:
            # deterministic full-image preprocess -> cache it finalized;
            # the random train crop below stays per-call
            def prep():
                image, gt_dot = load()
                return self._finalize_image(image), gt_dot

            image, gt_dot = self._cached(("prep", idx), prep)

        if self.train:
            rng = self._local_rng()
            r = rng.randint(0, image.shape[0] - self.crop_size + 1)
            c = rng.randint(0, image.shape[1] - self.crop_size + 1)
            sl = np.s_[r: r + self.crop_size, c: c + self.crop_size]
            img_patch, dot_patch = image[sl], gt_dot[sl]
            pts = np.argwhere(dot_patch > 0)  # (N, 2) y,x
            dists = self.knn_distances(pts)
            points = np.concatenate([pts.astype(np.float64), dists], axis=1)
            target = {
                "labels": np.ones(len(pts), np.int64),
                "points_macher": (points / self.crop_size).astype(np.float32),
                "points": (points[:, :3] / self.crop_size).astype(np.float32)
                if points.shape[1] >= 3 else
                (points / self.crop_size).astype(np.float32),
            }
            return [img_patch], [target]

        cs = self.crop_size
        num_h = image.shape[0] // cs
        num_w = image.shape[1] // cs
        patches, dot_patches = [], []
        for i in range(num_h):
            for j in range(num_w):
                patches.append(image[i * cs:(i + 1) * cs,
                                     j * cs:(j + 1) * cs])
                dot_patches.append(gt_dot[i * cs:(i + 1) * cs,
                                          j * cs:(j + 1) * cs])
        return np.stack(patches), np.stack(dot_patches).astype(np.float32)


# reference-name aliases
Data_Binary = DataBinary
Data_Reg = DataReg
Data_Reg_MT = DataRegMT
Data_Reg_Binary = DataRegBinary
