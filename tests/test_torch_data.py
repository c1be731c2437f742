"""PyTorch port: the data path (NIfTI codec, RAS reorientation,
intensity windowing, the phase-2 pretrain transform and loaders) against
the JAX package's ``data/``.

Volumes written by either codec read back bit-equal through both, with
the same affine; loaded volumes are bit-equal; the host windowing is bit
for bit the JAX package's (both take the native single-pass loop of
``native/miseg_native.cpp``), and its numpy plain version (``native=
False``) within 1 fp32 ulp at 1.0.  The random intensity and coarse
transforms give the JAX outputs bit for bit from the same generator
state; the pretrain transform and both pretrain loaders (the
self-supervised one in phase 1 too, with the multi-view crop count and
batch) give the JAX samples and batches at the same seed, bit for bit.
"""

from argparse import Namespace

import numpy as np
import pytest

from medical_image_segmentation_with_visual_prompts_tpu.data import \
    datasets as jax_datasets
from medical_image_segmentation_with_visual_prompts_tpu.data import \
    nifti as jax_nifti
from medical_image_segmentation_with_visual_prompts_tpu.data import \
    transforms as jax_tf
from medical_image_segmentation_with_visual_prompts_tpu_torch.data import (
    get_fit_loader_self_supervised_learning,
    get_fit_loader_supervised_learning, nifti, transforms)

AFFINES = {
    "identity": np.eye(4),
    # Axes permuted and flipped, with spacing and an offset.
    "permuted": np.array([[0.0, -0.8, 0.0, 10.0], [0.0, 0.0, 2.5, -3.0],
                          [-0.7, 0.0, 0.0, 4.0], [0.0, 0.0, 0.0, 1.0]]),
}


@pytest.mark.parametrize("affine", list(AFFINES))
@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.uint8])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_codec_round_trips_against_jax(tmp_path, affine, dtype, suffix):
    rng = np.random.default_rng(0)
    data = (rng.normal(0, 300, size=(7, 5, 3)) % 255).astype(dtype)
    aff = AFFINES[affine]
    for i, (save, loads) in enumerate((
            (nifti.save_nifti, (nifti.load_nifti, jax_nifti.load_nifti)),
            (jax_nifti.save_nifti, (nifti.load_nifti,)))):
        path = tmp_path / f"v{i}{suffix}"
        save(path, data, aff)
        for load in loads:
            got, got_aff = load(path)
            assert got.dtype == data.dtype
            np.testing.assert_array_equal(got, data)
            np.testing.assert_allclose(got_aff, aff, rtol=0, atol=1e-6)


@pytest.mark.parametrize("affine", list(AFFINES))
def test_load_image_matches_jax(tmp_path, affine):
    rng = np.random.default_rng(1)
    vol = rng.integers(-1024, 3071, size=(9, 6, 4)).astype(np.int16)
    path = tmp_path / "ct.nii.gz"
    jax_nifti.save_nifti(path, vol, AFFINES[affine])
    raw = transforms.load_image_raw(path)
    want = jax_tf.load_image_raw(path)
    assert raw.dtype == np.int16 and raw.shape == want.shape
    np.testing.assert_array_equal(raw, want)
    np.testing.assert_array_equal(transforms.load_image(path),
                                  jax_tf.load_image(path))
    np.testing.assert_array_equal(transforms.scale_intensity_range(raw),
                                  jax_tf.scale_intensity_range(raw))
    np.testing.assert_allclose(
        transforms.scale_intensity_range(raw, native=False),
        jax_tf.scale_intensity_range(raw), rtol=0, atol=2 ** -23)


def test_served_volume_ends(tmp_path):
    """load_served is what the JAX serving loader feeds (raw, or windowed
    on the host); write_labels embeds a crop in background 0."""
    rng = np.random.default_rng(2)
    vol = rng.integers(-1024, 3071, size=(9, 6, 4)).astype(np.int16)
    path = tmp_path / "ct.nii.gz"
    jax_nifti.save_nifti(path, vol)
    np.testing.assert_array_equal(transforms.load_served(path, raw=True),
                                  jax_tf.load_image_raw(path))
    want = jax_tf.scale_intensity_range(jax_tf.load_image(path))
    np.testing.assert_array_equal(transforms.load_served(path, raw=False),
                                  want)
    np.testing.assert_allclose(
        transforms.load_served(path, raw=False, native=False), want,
        rtol=0, atol=2 ** -23)
    crop = rng.integers(1, 3, size=(5, 4, 2)).astype(np.uint8)
    slices = (slice(2, 7), slice(1, 5), slice(1, 3))
    out = tmp_path / "seg.nii.gz"
    assert transforms.write_labels(out, crop, slices, (9, 6, 4)) == \
        sorted({0, *np.unique(crop).tolist()})
    got, _ = jax_nifti.load_nifti(out)
    want = np.zeros((9, 6, 4), np.int16)
    want[slices] = crop
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def test_scaled_payload_and_bad_file(tmp_path):
    """scl_slope/scl_inter promote to float32 as on the JAX side; a file
    that is not NIfTI raises."""
    path = tmp_path / "scaled.nii"
    nifti.save_nifti(path, np.arange(24, dtype=np.int16).reshape(4, 3, 2))
    raw = bytearray(path.read_bytes())
    raw[112:120] = np.array([0.5, -3.0], "<f4").tobytes()
    path.write_bytes(bytes(raw))
    got, _ = nifti.load_nifti(path)
    want, _ = jax_nifti.load_nifti(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    bad = tmp_path / "bad.nii"
    bad.write_bytes(b"\x00" * 400)
    with pytest.raises(ValueError, match="NIfTI"):
        nifti.load_nifti(bad)


AUGS = {
    "bias_field": lambda m, x, r: m.rand_bias_field(x, r),
    "std_shift": lambda m, x, r: m.rand_std_shift(x, r, (0.0, 0.2)),
    "contrast": lambda m, x, r: m.rand_adjust_contrast(x, r),
    "scale": lambda m, x, r: m.rand_scale_intensity(x, r, -2.0),
    "histogram_shift": lambda m, x, r: m.rand_histogram_shift(x, r),
    "dropout_in": lambda m, x, r: m.rand_coarse_dropout(
        x, r, holes=1, spatial_size=4, max_holes=3, max_spatial_size=16),
    "dropout_out": lambda m, x, r: m.rand_coarse_dropout(
        x, r, holes=5, spatial_size=32, max_spatial_size=48,
        dropout_holes=False),
    "shuffle": lambda m, x, r: m.rand_coarse_shuffle(
        x, r, holes=1, spatial_size=4, max_holes=3, max_spatial_size=16),
    "chain": lambda m, x, r: m._basic_intensity_augs(x, r, 0.9, (0.0, 0.2)),
}


@pytest.mark.parametrize("aug", list(AUGS))
def test_random_transforms_match_jax(aug):
    x = np.random.default_rng(3).uniform(0, 1, (16, 12, 8, 1)).astype(
        np.float32)
    for seed in range(3):
        got = AUGS[aug](transforms, x, np.random.default_rng(seed))
        want = AUGS[aug](jax_tf, x, np.random.default_rng(seed))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(transforms.get_coord_grid((5, 4, 3)),
                                  jax_tf.get_coord_grid((5, 4, 3)))


def _pretrain_set(root, n=4, seed=0):
    rng = np.random.default_rng(seed)
    for d in ("img", "msk"):
        (root / d).mkdir()
    for k in range(n):
        shape = (20 + k, 18 + 2 * k, 9 + k % 2)
        jax_nifti.save_nifti(root / "img" / f"case{k}.nii.gz",
                             rng.normal(0, 500, shape).astype(np.int16))
        jax_nifti.save_nifti(root / "msk" / f"case{k}.nii.gz",
                             rng.integers(0, 4, shape).astype(np.int16))
    return root


def _pretrain_conf(root, mode, **kw):
    conf = dict(training_mode=mode, image_dir_pretrain=str(root / "img"),
                image_dir_supervised=str(root / "img"),
                mask_dir_supervised=str(root / "msk"),
                image_dict_key="image", mask_dict_key="mask",
                num_selected_data_pretrain=-1,
                num_selected_data_supervised=-1, split_ratio=0.75,
                batch_size_students_teacher=2,
                num_samples_students_teacher=2, roi_size=[16, 16, 8],
                crop_size_students=[[12, 12, 8], [8, 8, 8]], num_workers=2,
                seed=5, use_prototype_assignment=True,
                random_transforms=True, random_orientation=True,
                resize_content=False, resize_spatial_size=[24, 20, 8])
    conf.update(kw)
    return Namespace(**conf)


def _same_sample(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "name":
            assert a[k] == b[k]
        elif k.startswith("image"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mode,kw", [
    ("supervised_learning_all", {}),
    ("self_supervised_learning_decoder", {}),
    ("supervised_learning_decoder", {"resize_content": True,
                                     "random_orientation": False}),
    ("self_supervised_learning_all", {"use_prototype_assignment": False}),
])
def test_pretrain_transform_matches_jax(tmp_path, mode, kw):
    conf = _pretrain_conf(_pretrain_set(tmp_path, n=1), mode, **kw)
    item = {"image": str(tmp_path / "img" / "case0.nii.gz"),
            "mask": str(tmp_path / "msk" / "case0.nii.gz"), "name": "case0"}
    for seed in range(6):
        got = transforms.transform_pretrain_fit(
            item, conf, np.random.default_rng(seed))
        want = jax_tf.transform_pretrain_fit(item, conf,
                                             np.random.default_rng(seed))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            _same_sample(a, b)
        students = kw.get("use_prototype_assignment", True)
        assert ("image_st_1" in got[0]) == students
        if students:
            assert got[0]["coord_st_1"].shape == (8, 8, 8, 3)
            assert ("mask_st_0" in got[0]) == mode.startswith("supervised")


@pytest.mark.parametrize("supervised", [False, True])
def test_pretrain_loaders_give_the_jax_batches(tmp_path, supervised):
    mode = "supervised_learning_all" if supervised \
        else "self_supervised_learning_all"
    conf = _pretrain_conf(_pretrain_set(tmp_path, n=5), mode)
    ours = (get_fit_loader_supervised_learning if supervised
            else get_fit_loader_self_supervised_learning)(conf)
    theirs = (jax_datasets.get_fit_loader_supervised_learning if supervised
              else jax_datasets.get_fit_loader_self_supervised_learning)(conf)
    for a, b in zip(ours, theirs):
        assert a.drop_last and len(a) == len(b)
        for epoch in range(2):
            got, want = list(a), list(b)
            assert len(got) == len(want) == len(a) > 0, epoch
            for x, y in zip(got, want):
                _same_sample(x, y)
                assert x["image_st_0"].shape == (2, 12, 12, 8, 1)


def test_phase1_loader_gives_the_jax_batches(tmp_path):
    """``self_supervised_learning_encoder``: the self-supervised loaders
    serve phase 1 with ``num_samples_multi_view`` crops per volume in
    batches of ``batch_size_multi_view``, images only."""
    conf = _pretrain_conf(_pretrain_set(tmp_path, n=5),
                          "self_supervised_learning_encoder",
                          num_samples_multi_view=3, batch_size_multi_view=2)
    ours = get_fit_loader_self_supervised_learning(conf)
    theirs = jax_datasets.get_fit_loader_self_supervised_learning(conf)
    for a, b in zip(ours, theirs):
        assert a.drop_last and len(a) == len(b)
        for epoch in range(2):
            got, want = list(a), list(b)
            assert len(got) == len(want) == len(a) > 0, epoch
            for x, y in zip(got, want):
                _same_sample(x, y)
                assert sorted(x) == ["image", "name"]
                assert x["image"].shape == (2, 16, 16, 8, 1)
