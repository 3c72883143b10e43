"""The port's train data pipeline against the JAX package's, on the CPU.

The HSV conversions are held bit for bit to PIL's (which the JAX pipeline
calls) over every 8-bit input; each train transform, the pipeline, Rare-
Class Sampling, the DG and UDA datasets and the one-worker loader give what
the JAX package gives from the same seed, bit for bit.
"""

import os
import runpy
import sys

import numpy as np
import pytest

from vfmseg_tpu.data import datasets as jax_datasets
from vfmseg_tpu.data import loader as jax_loader
from vfmseg_tpu.data import synthetic as jax_synthetic
from vfmseg_tpu.data import transforms as jax_transforms
from vfmseg_tpu_torch.data import datasets, loader, synthetic, transforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCS = dict(class_temp=0.01, min_crop_ratio=0.5, min_pixels=50)
PIPELINE = dict(resize_scale_wh=(256, 256), crop_size=(128, 128),
                cat_max_ratio=0.75, flip_prob=0.5, photometric=True)


def _all_triples() -> np.ndarray:
    """Every (a, b, c) byte triple once, as a 4096 x 4096 image."""
    a = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(a >> 16) & 255, (a >> 8) & 255, a & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 3)


def test_rgb_to_hsv_bit_equal_to_pil_everywhere():
    img = _all_triples()
    np.testing.assert_array_equal(transforms.rgb_to_hsv(img),
                                  jax_transforms._rgb_to_hsv(img))


def test_hsv_to_rgb_bit_equal_to_pil_everywhere():
    img = _all_triples()
    np.testing.assert_array_equal(transforms.hsv_to_rgb(img),
                                  jax_transforms._hsv_to_rgb(img))


def _image(seed, hw=(53, 71)):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, hw + (3,)).astype(np.uint8)
    label = rs.randint(0, 6, hw).astype(np.uint8)
    label[rs.rand(*hw) < 0.1] = 255
    return img, label


def _pair(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", range(4))
def test_train_transforms_bit_equal_to_jax(seed):
    """Resize with scale jitter, the cat-max-ratio crop (its redraws),
    flip, normalise-pad, and the rng left in the same state."""
    img, label = _image(seed)
    r1, r2 = _pair(seed)
    scales = [24, 32, 48, 64, 80]
    _equal(transforms.random_choice_resize_shortest_edge(img, label, scales,
                                                         90, r1),
           jax_transforms.random_choice_resize_shortest_edge(
               img, label, scales, 90, r2))
    for ratio in (1.0, 0.75, 0.3):
        _equal(transforms.random_crop(img, label, (32, 40), r1, ratio),
               jax_transforms.random_crop(img, label, (32, 40), r2, ratio))
    _equal(transforms.random_crop(img, label, (64, 90), r1, 0.75),
           jax_transforms.random_crop(img, label, (64, 90), r2, 0.75))
    for _ in range(3):
        _equal(transforms.random_flip(img, label, r1),
               jax_transforms.random_flip(img, label, r2))
    _equal(transforms.normalize_pad(img, label, (64, 80)),
           jax_transforms.normalize_pad(img, label, (64, 80)))
    _equal(transforms.normalize_pad(img, None, (53, 71)),
           jax_transforms.normalize_pad(img, None, (53, 71)))
    assert r1.random() == r2.random()


@pytest.mark.parametrize("seed", range(6))
def test_photometric_distortion_bit_equal_to_jax(seed):
    """Every branch (brightness, contrast first or last, saturation, hue)
    over a few draws."""
    img, _ = _image(seed + 10)
    r1, r2 = _pair(seed)
    for _ in range(4):
        _equal(transforms.photometric_distortion(img, r1),
               jax_transforms.photometric_distortion(img, r2))
    assert r1.random() == r2.random()


@pytest.mark.parametrize("jitter", [False, True])
def test_train_pipeline_bit_equal_to_jax(jitter):
    img, label = _image(3, (90, 120))
    kw = dict(resize_scale_wh=(100, 80), crop_size=(64, 64))
    if jitter:
        kw.update(scale_jitter_scales=[48, 64, 96], scale_jitter_max_size=150)
    r1, r2 = _pair(7)
    for _ in range(4):
        _equal(transforms.TrainPipeline(**kw)(img, label, r1),
               jax_transforms.TrainPipeline(**kw)(img, label, r2))


def test_synthetic_dataset_pipeline_matches_jax():
    pipe = dict(resize_scale_wh=(96, 96), crop_size=(64, 64))
    ours = synthetic.SyntheticDataset(
        n=3, hw=(80, 80), num_classes=5, seed=4,
        pipeline=transforms.TrainPipeline(**pipe))
    theirs = jax_synthetic.SyntheticDataset(
        n=3, hw=(80, 80), num_classes=5, seed=4,
        pipeline=jax_transforms.TrainPipeline(**pipe))
    for i in (0, 2, 1, 0):
        _equal(ours[i], theirs[i])


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """8 samples of 256 x 256 in the GTA layout with the RCS stats files,
    written by tools/make_synthetic_dataset.py."""
    root = str(tmp_path_factory.mktemp("synth_gta"))
    argv = sys.argv
    sys.argv = ["make_synthetic_dataset.py", root, "--n", "8", "--size",
                "256"]
    try:
        runpy.run_path(os.path.join(REPO, "tools",
                                    "make_synthetic_dataset.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    return root


def test_rcs_class_probs_match_jax(synth_root):
    for temp in (0.01, 0.1, 1.0):
        classes, probs = datasets.rcs_class_probs(synth_root, temp)
        want_c, want_p = jax_datasets.rcs_class_probs(synth_root, temp)
        assert classes == want_c
        np.testing.assert_allclose(probs, want_p, rtol=1e-12, atol=0)


def _dg(mod_datasets, mod_transforms, root, rcs=RCS):
    return mod_datasets.DGDataset(
        mod_datasets.gta_dataset(root),
        mod_transforms.TrainPipeline(**PIPELINE),
        rare_class_sampling=rcs, seed=3)


@pytest.mark.parametrize("rcs", [RCS, None])
def test_dg_dataset_draws_bit_equal_to_jax(synth_root, rcs):
    """6 draws with Rare-Class Sampling (class, file, crop retries) and
    without it."""
    ours = _dg(datasets, transforms, synth_root, rcs)
    theirs = _dg(jax_datasets, jax_transforms, synth_root, rcs)
    assert len(ours) == len(theirs) == 8
    if rcs:
        assert ours.samples_with_class == theirs.samples_with_class
        assert ours.file_to_idx == theirs.file_to_idx
    for i in (5, 0, 7, 3, 3, 1):
        _equal(ours[i], theirs[i])


def test_uda_dataset_draws_bit_equal_to_jax(synth_root):
    def build(mod_datasets, mod_transforms):
        return mod_datasets.UDADataset(
            mod_datasets.gta_dataset(synth_root),
            mod_datasets.gta_dataset(synth_root),
            mod_transforms.TrainPipeline(**PIPELINE),
            target_pipeline=mod_transforms.TrainPipeline(
                resize_scale_wh=(200, 160), crop_size=(96, 96)),
            rare_class_sampling=RCS, seed=9)

    ours, theirs = build(datasets, transforms), build(jax_datasets,
                                                      jax_transforms)
    assert len(ours) == len(theirs) == 64
    for i in (0, 63, 5, 12, 12, 40):
        _equal(ours[i], theirs[i])


def test_one_worker_loader_bit_equal_to_jax(synth_root):
    """InfiniteLoader(num_workers=1) over the RCS dataset: the same
    shuffles and batches; a permutation of 8 spans several batches."""
    ours = loader.InfiniteLoader(_dg(datasets, transforms, synth_root),
                                 batch_size=3, num_workers=1, seed=5)
    theirs = jax_loader.InfiniteLoader(
        _dg(jax_datasets, jax_transforms, synth_root), batch_size=3,
        num_workers=1, seed=5)
    try:
        for _ in range(4):
            _equal(next(ours), next(theirs))
    finally:
        ours.close()
        theirs.close()
