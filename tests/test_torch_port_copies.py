"""The port's own copies of the framework-free modules (cli/config.py, data/*,
eval/matching.py, eval/peaks.py, the report accumulators in
eval/results.py, utils/logger.py, and the native pairing native/ph0.*)
against their
originals in the JAX package: on the same seeded numpy inputs both give
equal values, not close ones."""

import dataclasses
import glob
import importlib
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(name, port_name=None):
    return (importlib.import_module(f"unet_torch_tpu.{name}"),
            importlib.import_module(
                f"unet_torch_tpu_torch.{port_name or name}"))


def _assert_equal(a, b, path="value"):
    """Deep equality of nested dicts, sequences, arrays and scalars; NaN
    equals NaN."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(a, (float, np.floating)):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)
    else:
        assert a == b, path


def _both(pair, fn):
    """fn(module) on the original and on the copy must give equal values."""
    jax_side, port_side = fn(pair[0]), fn(pair[1])
    _assert_equal(jax_side, port_side)
    return port_side


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from unet_torch_tpu.data.synthetic import write_synthetic_dataset

    root = tmp_path_factory.mktemp("copies")
    write_synthetic_dataset(str(root / "rgb"), n_images=5, size=48,
                            n_classes=3, seed=3)
    write_synthetic_dataset(str(root / "gray"), n_images=2, size=48,
                            n_classes=3, seed=4, grayscale=True)
    return root


# ---------------------------------------------------------------- cli/config

@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "configs", "*.yml"))))
def test_config_load_equals_original(path):
    cfg = _both(_pair("cli.config"),
                lambda m: m.Config.load(os.path.join(ROOT, path)))
    assert cfg.model.model_type


def test_config_defaults_and_snapshot_equal_original(tmp_path):
    def run(m):
        cfg = m.Config.from_dict({"train_config": {"seed": 3,
                                                   "lr_rate": [0.01]}})
        out = tmp_path / m.__name__
        cfg.dump_snapshot(str(out))
        return cfg, (out / "config.json").read_text()

    _both(_pair("cli.config"), run)


# ------------------------------------------------------------------ data/io

_IO_CASES = {
    "natural_sort": lambda m, d: m.natural_sort(
        ["b10.png", "b2.png", "a1.png", "B3.png", "b02.png"]),
    "get_image_list": lambda m, d: [os.path.basename(p) for p in
                                    m.get_image_list([str(d / "rgb")])],
    "get_image_list_str": lambda m, d: [os.path.basename(p) for p in
                                        m.get_image_list(str(d / "gray"))],
    "decode_rgb": lambda m, d: m.decode_image(str(d / "rgb" / "img0.png"), 3),
    "decode_gray": lambda m, d: m.decode_image(
        str(d / "gray" / "img0.png"), 1),
    "decode_hematoxylin": lambda m, d: m.decode_image(
        str(d / "rgb" / "img1.png"), -1),
    "z_normalize_hwc": lambda m, d: m.z_normalize(
        np.random.RandomState(0).rand(20, 24, 3).astype(np.float32) * 255),
    "z_normalize_hw": lambda m, d: m.z_normalize(
        np.random.RandomState(1).rand(20, 24) * 255),
    "zoom_resize_image": lambda m, d: m.zoom_resize(
        np.random.RandomState(2).rand(20, 24, 3), 32, 28, order=3),
    "zoom_resize_label": lambda m, d: m.zoom_resize(
        np.random.RandomState(3).randint(0, 3, (20, 24)), 32, 28, order=0),
    "to_model_input": lambda m, d: m.to_model_input(
        np.random.RandomState(4).rand(8, 8)),
    "load_and_preprocess": lambda m, d: m.load_and_preprocess(
        str(d / "rgb" / "img2.png"), 3, (32, 32)),
}


@pytest.mark.parametrize("case", sorted(_IO_CASES))
def test_io_equals_original(case, dataset):
    _both(_pair("data.io"), lambda m: _IO_CASES[case](m, dataset))


# --------------------------------------------------------------- data/stain

def _stain_inputs():
    rng = np.random.RandomState(5)
    return (rng.randint(40, 250, (24, 24, 3)).astype(np.uint8),
            rng.randint(40, 250, (24, 24, 3)).astype(np.uint8))


_STAIN_CASES = {
    "rgb2hed": lambda m: m.rgb2hed(_stain_inputs()[0]),
    "hematoxylin_channel": lambda m: m.hematoxylin_channel(
        _stain_inputs()[0]),
    "macenko": lambda m: m.MacenkoNormalizer().fit(
        _stain_inputs()[0]).transform(_stain_inputs()[1]),
}


@pytest.mark.parametrize("case", sorted(_STAIN_CASES))
def test_stain_equals_original(case):
    _both(_pair("data.stain"), _STAIN_CASES[case])


# ------------------------------------------------------------- data/augment

def _aug_samples(seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (32, 32, 3)).astype(np.uint8)
    label = rng.randint(0, 3, (32, 32)).astype(np.uint8)
    heat = rng.rand(32, 32).astype(np.float32)
    return img, label, heat


_AUG_CASES = {
    "random_rot_flip": lambda m: m.random_rot_flip(
        list(_aug_samples(0)), np.random.RandomState(10)),
    "random_rotate": lambda m: m.random_rotate(
        list(_aug_samples(1)), np.random.RandomState(11)),
    "basic_geometric": lambda m: [m.basic_geometric(
        list(_aug_samples(2)), np.random.RandomState(s)) for s in range(4)],
    "pad_image": lambda m: m.pad_image(list(_aug_samples(3))[:2], 5, 3,
                                       np.random.RandomState(13)),
    "color_jitter": lambda m: m.color_jitter(
        _aug_samples(4)[0], np.random.RandomState(12)),
    "pathology_augment_hm": lambda m: [m.pathology_augment_hm(
        _aug_samples(5)[0], [_aug_samples(5)[2]], np.random.RandomState(s))
        for s in range(6)],
}


@pytest.mark.parametrize("case", sorted(_AUG_CASES))
def test_augment_equals_original(case):
    _both(_pair("data.augment"), _AUG_CASES[case])


# --------------------------------------- data/datasets, loader, nested, synth

def _items(ds, n=None):
    return [ds[i] for i in range(n or len(ds))]


_DATASET_CASES = {
    "DataBinary": lambda m, d: _items(m.DataBinary(
        [str(d / "rgb")], ch=3, input_size=(32, 32), seed=1)),
    "DataBinary_aug_gt_dot": lambda m, d: _items(m.DataBinary(
        [str(d / "rgb")], ch=3, augmentation=True, input_size=(48, 48),
        seed=2, return_gt_dot=True)),
    "DataBinary_gray": lambda m, d: _items(m.DataBinary(
        [str(d / "gray")], ch=1, input_size=(32, 32), seed=1)),
    "DataReg": lambda m, d: _items(m.DataReg(
        [str(d / "rgb")], ch=3, input_size=(32, 32), seed=1)),
    "DataReg_aug_photometric": lambda m, d: _items(m.DataReg(
        [str(d / "rgb")], ch=3, augmentation=True, photometric=True,
        input_size=(48, 48), seed=3)),
    "DataRegMT": lambda m, d: _items(m.DataRegMT(
        [str(d / "rgb")], ch=3, input_size=(32, 32), seed=1)),
    "DataRegMT_aug": lambda m, d: _items(m.DataRegMT(
        [str(d / "rgb")], ch=3, augmentation=True, input_size=(48, 48),
        seed=4)),
    "DataRegBinary": lambda m, d: _items(m.DataRegBinary(
        [str(d / "rgb")], ch=3, input_size=(32, 32), seed=1)),
    "DataRandomCrop_train": lambda m, d: _items(m.DataRandomCrop(
        [str(d / "rgb")], ch=3, augmentation=True, train=True, crop_size=32,
        seed=5)),
    "DataRandomCrop_val": lambda m, d: _items(m.DataRandomCrop(
        [str(d / "rgb")], ch=3, train=False, crop_size=32, seed=5), 2),
}


@pytest.mark.parametrize("case", sorted(_DATASET_CASES))
def test_datasets_equal_original(case, dataset):
    _both(_pair("data.datasets"), lambda m: _DATASET_CASES[case](m, dataset))


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, shuffle=True, seed=7),
    dict(batch_size=2, shuffle=False, num_workers=2),
    dict(batch_size=2, shuffle=True, seed=7, shard_index=1, num_shards=2),
], ids=["shuffled", "workers", "sharded"])
def test_numpy_loader_batches_equal_original(kw, dataset):
    datasets, loaders = _pair("data.datasets"), _pair("data.loader")

    def run(i):
        ds = datasets[i].DataRegMT([str(dataset / "rgb")], ch=3,
                                   input_size=(32, 32), seed=1)
        loader = loaders[i].NumpyLoader(ds, **kw)
        # two epochs: the shuffle advances
        return len(loader), [list(loader), list(loader)]

    _assert_equal(run(0), run(1))


def test_nested_equals_original():
    rng = np.random.RandomState(6)
    images = [rng.rand(30, 40, 3).astype(np.float32),
              rng.rand(50, 20, 3).astype(np.float32)]
    _both(_pair("data.nested"), lambda m: (
        m.nested_batch(images, bucket=32),
        m.pad_and_tile(rng.__class__(7).rand(70, 50, 3), 32)))


def test_synthetic_dataset_equals_original(tmp_path):
    def run(m):
        rng = np.random.RandomState(8)
        root = m.write_synthetic_dataset(str(tmp_path / m.__name__),
                                         n_images=2, size=32, seed=9)
        files = sorted(os.listdir(root))
        return (m.make_blob_sample(rng, size=32), files,
                [open(os.path.join(root, f), "rb").read() for f in files])

    _both(_pair("data.synthetic"), run)


# ------------------------------------------------- eval/matching, eval/peaks

def _dots(seed, n=12, size=64):
    rng = np.random.RandomState(seed)
    dot = np.zeros((size, size), np.uint8)
    dot[rng.randint(4, size - 4, n), rng.randint(4, size - 4, n)] = 1
    return dot


def _density(seed, size=64):
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(_dots(seed, size=size).astype(np.float64), 2.0)


def _blobs(seed, size=64):
    yy, xx = np.mgrid[:size, :size]
    mask = np.zeros((size, size), np.uint8)
    for y, x in zip(*np.nonzero(_dots(seed, 8, size))):
        mask[(yy - y) ** 2 + (xx - x) ** 2 <= 9] = 1
    return mask


_MATCHING_CASES = {
    "calculate_estimated_coordinates":
        lambda m: m.calculate_estimated_coordinates(_blobs(0)),
    "matlab_style_gauss": lambda m: m.matlab_style_gauss((7, 7), 1.5),
    "crowd_matching_test_coordinates": lambda m: m.crowd_matching_test(
        _dots(1), m.calculate_estimated_coordinates(_blobs(1)), [5, 20],
        list(np.arange(0.5, 1, 0.05)), input_type="Coordinates"),
    "crowd_matching_test_regression": lambda m: m.crowd_matching_test(
        _dots(2), _density(2), [5, 20], list(np.arange(0.5, 1, 0.05)),
        input_type="Regression"),
    "crowd_matching_greedy": lambda m: m.crowd_matching_greedy(
        _dots(3), m.calculate_estimated_coordinates(_blobs(4)), 10),
    "crowd_matching_greedy_empty_gt": lambda m: m.crowd_matching_greedy(
        np.zeros((64, 64), np.uint8),
        m.calculate_estimated_coordinates(_blobs(4)), 10),
    "count_accuracy_metric": lambda m: [m.count_accuracy_metric(g, p)
                                        for g, p in ((10, 8), (0, 3), (0, 0),
                                                     (5, 9))],
    "gmae": lambda m: [m.gmae(L, _dots(5), _density(6), 64)
                       for L in (1, 2, 3)],
}


@pytest.mark.parametrize("case", sorted(_MATCHING_CASES))
def test_matching_equals_original(case):
    _both(_pair("eval.matching"), _MATCHING_CASES[case])


@pytest.mark.parametrize("kw", [dict(min_distance=1), dict(min_distance=3),
                                dict(min_distance=2, threshold_abs=0.01)],
                         ids=["d1", "d3", "d2_thresh"])
def test_peaks_equal_original(kw):
    _both(_pair("eval.peaks"), lambda m: m.peak_local_max(_density(7), **kw))


# ------------------------------------------------------------- eval/results

def _run_results2(m, out):
    res = m.Results2Class(str(out), save_image=False)
    for s in range(3):
        gt = _blobs(s) + _blobs(s + 10) * (1 - _blobs(s))
        pred = _blobs(s + 1) + _blobs(s + 10) * (1 - _blobs(s + 1))
        gt[gt > 0] = 1 + (np.arange(gt[gt > 0].size) % 2)
        gt_dot = _dots(s) * 1 + _dots(s + 10) * (1 - _dots(s)) * 2
        res.imageNames.append(f"img{s}.png")
        res.compare_images(np.zeros((64, 64, 3), np.uint8), gt.astype(
            np.uint8), pred.astype(np.uint8), gt_dot.astype(np.uint8))
    res.save()
    return res.get_results()


def _run_results3(m, out):
    res = m.Results3Class(str(out), save_image=False)
    for s in range(3):
        gt = (_blobs(s) + 2 * _blobs(s + 10) * (1 - _blobs(s))
              + 3 * _blobs(s + 20) * (1 - _blobs(s)) * (1 - _blobs(s + 10)))
        pred = np.roll(gt, 2, axis=1)
        res.imageNames.append(f"img{s}.png")
        res.compare_images(np.zeros((64, 64, 3), np.uint8),
                           gt.astype(np.uint8), pred.astype(np.uint8))
    res.save()
    return res.get_results()


def _run_regression(m, out):
    res = m.RegressionResults(str(out), heads=("immune", "other"))
    for s in range(3):
        res.imageNames.append(f"img{s}.png")
        res.add("immune", _density(s), _dots(s).astype(np.float64))
        res.add("other", _density(s + 5) * 1.2,
                _dots(s + 5).astype(np.float64))
    res.save()
    return res.get_results()


def _run_cc(m, out):
    res = m.ResultsCC(str(out), save_img=False)
    for s in range(3):
        res.imageNames.append(f"img{s}.png")
        res.compare_images(np.zeros((64, 64), np.uint8), _blobs(s),
                           _blobs(s + (s % 2)), _dots(s, 8))
    res.save()
    return res.get_results()


def _run_two_channel(m, out):
    res = m.TwoChannelRegResults(str(out))
    for s in range(3):
        res.sample_list.append(f"img{s}.png")
        res.add(_density(s), _density(s + 5) * 0.8,
                _dots(s).astype(np.float64), _dots(s + 5).astype(np.float64))
    res.save()
    return res.get_results()


_RESULTS_CASES = {
    "Results2Class": _run_results2,
    "Results3Class": _run_results3,
    "RegressionResults": _run_regression,
    "ResultsCC": _run_cc,
    "TwoChannelRegResults": _run_two_channel,
}


@pytest.mark.parametrize("case", sorted(_RESULTS_CASES))
def test_results_classes_equal_original(case, tmp_path):
    originals, port = _pair("eval.reports", "eval.results")

    def csvs(d):
        return {f: open(os.path.join(d, f)).read()
                for f in sorted(os.listdir(d)) if f.endswith(".csv")}

    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    a = _RESULTS_CASES[case](originals, tmp_path / "jax")
    b = _RESULTS_CASES[case](port, tmp_path / "port")
    assert a, "empty results"
    _assert_equal(a, b)
    _assert_equal(csvs(tmp_path / "jax"), csvs(tmp_path / "port"))


_RESULTS_FN_CASES = {
    "noise_filtering": lambda m, d: m.noise_filtering(
        (_blobs(0) + 2 * _blobs(3) * (1 - _blobs(0))).astype(np.uint8), 20),
    "preprocess_eval": lambda m, d: m.preprocess_eval(
        m._load_eval_image(str(d / "rgb" / "img0.png"), 3), (32, 32)),
    "load_eval_image_gray": lambda m, d: m._load_eval_image(
        str(d / "gray" / "img0.png"), 1),
    "create_label_coordinates_2class":
        lambda m, d: m.create_label_coordinates_2class(
            str(d / "rgb" / "img0.tsv"), (48, 48)),
    "gt_dots_for_tsv": lambda m, d: m._gt_dots_for(
        str(d / "rgb" / "img1.png"),
        {"img1": str(d / "rgb" / "img1.tsv")}, (48, 48)),
    "gt_dots_for_png": lambda m, d: m._gt_dots_for(
        str(d / "rgb" / "img1.png"), None, (48, 48)),
}


@pytest.mark.parametrize("case", sorted(_RESULTS_FN_CASES))
def test_results_functions_equal_original(case, dataset):
    _both(_pair("eval.reports", "eval.results"),
          lambda m: _RESULTS_FN_CASES[case](m, dataset))


# ------------------------------------------------------------- native/ph0

def test_native_source_is_the_original():
    port = os.path.join(ROOT, "unet_torch_tpu_torch", "native", "ph0.cpp")
    original = os.path.join(ROOT, "unet_torch_tpu", "native", "ph0.cpp")
    assert open(port, "rb").read() == open(original, "rb").read()


def _ph0_inputs():
    """tests/test_native.py's cases: a random map, three blobs, a mask of
    three components; and a larger map with a plateau of ties."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:32, :32]
    blobs = np.zeros((32, 32), np.float32)
    for cy, cx in [(8, 8), (24, 24), (8, 24)]:
        blobs += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
    mask = np.zeros((16, 16), np.uint8)
    mask[2:5, 2:5] = 1
    mask[10:12, 10:12] = 1
    mask[0, 15] = 1
    ties = np.random.RandomState(1).rand(96, 96).astype(np.float32)
    ties[10:30, 40:60] = 0.5
    return (rng.rand(24, 24).astype(np.float32), np.clip(blobs, 0, 1),
            mask, ties)


@pytest.mark.parametrize("case", ["random", "blobs", "ties"])
@pytest.mark.parametrize("bars", [16, 64])
def test_native_ph0_equals_original(case, bars):
    img = dict(zip(("random", "blobs", "ties"),
                   np.array(_ph0_inputs(), dtype=object)[[0, 1, 3]]))[case]
    _both(_pair("native.ph0"), lambda m: list(m.superlevel_ph0(img, bars)))


def test_native_count_components_equals_original():
    mask = _ph0_inputs()[2]
    assert _both(_pair("native.ph0"), lambda m: m.count_components(mask)) == 3


# ------------------------------------------------------------ utils/logger

def test_logger_equals_original(monkeypatch):
    """The same series through SmoothedValue and MetricLogger.log_every,
    with a clock that ticks alike for both: equal values and lines."""
    import time

    def run(m):
        clock = iter(np.arange(0.0, 100.0, 0.25))
        monkeypatch.setattr(time, "time", lambda: float(next(clock)))
        value = m.SmoothedValue(window_size=4)
        for x in (3.0, 1.0, 4.0, 1.0, 5.0, 9.0):
            value.update(x, n=2)
        lines = []
        logger = m.MetricLogger(print_fn=lines.append)
        for i in logger.log_every(list(range(7)), 3, header="Epoch 2"):
            logger.update(loss=1.0 / (i + 1), acc=i)
        return ([value.median, value.avg, value.global_avg, value.max,
                 value.value, str(value)], str(logger), lines)

    _both(_pair("utils.logger"), run)
