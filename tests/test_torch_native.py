"""PyTorch port: the native data-path library (``data/native.py``).

The port builds ``native/miseg_native.cpp`` itself into ``build/native/``
(never the committed ``native/libmiseg_native.so``).  Its four entries
against numpy: gunzip and every NIfTI datatype's decode bit for bit,
windowing bit for bit to the same formula in float32 numpy and within one
fp32 ulp of the numpy plain version, window gathers bit for bit.  The
port's native readers against the JAX package's (which binds the same
source): ``load_nifti`` of float32 and int16 ``.nii.gz`` and
``scale_intensity_range`` bit for bit.  The build takes its lock (one
library from concurrent first uses) and raises with the compiler's
output.
"""

import gzip
import threading

import numpy as np
import pytest

from medical_image_segmentation_with_visual_prompts_tpu.data import \
    nifti as jax_nifti
from medical_image_segmentation_with_visual_prompts_tpu.data import \
    transforms as jax_tf
from medical_image_segmentation_with_visual_prompts_tpu_torch.data import (
    native, nifti, transforms)

# NIfTI datatype code -> numpy dtype, as miseg_decode_f32 reads them.
DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
          64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32}
SHAPE = (70, 9, 67)       # more than one 64x64 tile of the transpose


def test_builds_its_own_library():
    lib = native.library()
    assert native.library_path().parent.name == "native"
    assert native.library_path().parent.parent.name == "build"
    assert lib._name == str(native.library_path())


def test_gunzip_bytes_identical():
    payload = np.random.default_rng(0).integers(
        0, 7, size=300_000).astype(np.uint8).tobytes()
    packed = gzip.compress(payload, compresslevel=1)
    out = native.gunzip(packed)
    assert out.dtype == np.uint8 and out.tobytes() == payload
    with pytest.raises(ValueError):
        native.gunzip(packed[:10])


@pytest.mark.parametrize("code", sorted(DTYPES))
def test_decode_every_datatype(code):
    rng = np.random.default_rng(code)
    dtype = np.dtype(DTYPES[code])
    if dtype.kind == "f":
        vol = rng.normal(0, 300, SHAPE).astype(dtype)
    else:
        info = np.iinfo(dtype)
        vol = rng.integers(info.min, info.max, SHAPE, endpoint=True,
                           dtype=dtype)
    payload = vol.tobytes(order="F")
    ident = native.decode_f32(payload, code, SHAPE, 1.0, 0.0)
    np.testing.assert_array_equal(ident, vol.astype(np.float32))
    assert ident.flags["C_CONTIGUOUS"]
    scaled = native.decode_f32(np.frombuffer(payload, np.uint8), code,
                               SHAPE, 0.5, -3.0)
    np.testing.assert_array_equal(
        scaled, vol.astype(np.float32) * np.float32(0.5) + np.float32(-3.0))


def test_decode_refuses_bad_input():
    with pytest.raises(ValueError, match="datatype"):
        native.decode_f32(b"\0" * 64, 1024, (2, 2, 2), 1.0, 0.0)
    with pytest.raises(ValueError, match="payload"):
        native.decode_f32(b"\0" * 15, 16, (2, 2, 1), 1.0, 0.0)


def test_scale_intensity_within_one_ulp():
    x = np.random.default_rng(1).normal(0, 800, SHAPE).astype(np.float32)
    got = x.copy()
    assert native.scale_intensity(got, -1000.0, 1000.0, 0.0, 1.0, True)
    scale = np.float32(1.0) / np.float32(2000.0)
    want = np.clip((x + np.float32(1000.0)) * scale, 0.0, 1.0)
    np.testing.assert_array_equal(got, want)
    plain = transforms.scale_intensity_range(x, native=False)
    np.testing.assert_allclose(got, plain, rtol=0, atol=2 ** -23)
    with pytest.raises(ValueError):
        native.scale_intensity(x.astype(np.float64), -1, 1, 0, 1, True)


def test_extract_windows_identical():
    rng = np.random.default_rng(2)
    vol = rng.normal(size=(12, 10, 6, 2)).astype(np.float32)
    starts = np.array([[0, 0, 0], [4, 2, 2], [8, 6, 2]])
    got = native.extract_windows(vol, starts, (4, 4, 4))
    want = np.stack([vol[h:h + 4, w:w + 4, d:d + 4] for h, w, d in starts])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        native.extract_windows(vol, np.array([[10, 0, 0]]), (4, 4, 4))


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_load_nifti_matches_jax_bit_for_bit(tmp_path, dtype):
    rng = np.random.default_rng(3)
    vol = rng.normal(0, 500, SHAPE).astype(dtype)
    path = tmp_path / "v.nii.gz"
    jax_nifti.save_nifti(path, vol)
    got, aff = nifti.load_nifti(path)
    want, want_aff = jax_nifti.load_nifti(path)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(aff, want_aff)
    plain, _ = nifti.load_nifti(path, native=False)
    np.testing.assert_array_equal(plain, got)


def test_scale_intensity_range_matches_jax():
    raw = np.random.default_rng(4).integers(
        -1024, 3071, size=(20, 18, 6, 1)).astype(np.int16)
    got = transforms.scale_intensity_range(raw)
    np.testing.assert_array_equal(got, jax_tf.scale_intensity_range(raw))
    np.testing.assert_allclose(
        transforms.scale_intensity_range(raw, native=False), got, rtol=0,
        atol=2 ** -23)


def test_build_is_locked_and_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_BUILD", tmp_path / "lib")
    errors = []

    def first_use():
        try:
            native.build()
        except Exception as e:          # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert sorted(p.name for p in (tmp_path / "lib").iterdir()) == [
        ".lock", native.library_path().name]
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()
