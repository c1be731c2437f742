"""PyTorch port: Gaussian-stitched sliding-window serving against the JAX
package.

* The window-grid helpers are numpy on both sides: equality.
* The stitch is held against JAX ``BucketedInference`` (coset stitch,
  fp32) with the same elementwise stand-in model on both sides, at
  strides 0.5, 0.75 and 1.0 and coverage pad and crop: 1e-5 on
  probabilities (summation order of the overlap-add).
* The serving CLI runs end to end on a tiny int16 NIfTI from a ``.pt``
  written by ``export_state_dict``; its labels are held against the JAX
  model served through JAX ``BucketedInference`` on the same volume and
  weights (fp32 both): at least 99.9% equal voxels (argmax ties at fp32
  reassociation noise may flip).
* ``infer.segment_volume`` (the Python API) against the JAX package's on
  the same preprocessed volume and weights: the same 99.9%, background
  outside the centre crop; ``serve_volumes`` gives the same labels with
  the native and the numpy decoder.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from medical_image_segmentation_with_visual_prompts_tpu import \
    infer as jax_infer
from medical_image_segmentation_with_visual_prompts_tpu.data.nifti import (
    load_nifti, save_nifti)
from medical_image_segmentation_with_visual_prompts_tpu.parallel import \
    sliding_window as jax_sw
from medical_image_segmentation_with_visual_prompts_tpu.utils.torch_export \
    import export_state_dict
from medical_image_segmentation_with_visual_prompts_tpu_torch import infer
from medical_image_segmentation_with_visual_prompts_tpu_torch.parallel import \
    sliding_window as sw

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_swin_unetr import jax_model, tiny_conf  # noqa: E402

ROI = (16, 16, 8)
STRIDES = (0.5, 0.75, 1.0)


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("dims", [(40, 36, 20), (16, 16, 8), (23, 17, 9)])
def test_grid_helpers_match_jax(stride, dims):
    assert sw.resolve_stride(ROI, stride) == jax_sw.resolve_stride(ROI, stride)
    a, b = sw.window_starts(dims, ROI, stride), \
        jax_sw.window_starts(dims, ROI, stride)
    assert a[0] == b[0] and a[2] == b[2]
    np.testing.assert_array_equal(a[1], b[1])
    assert sw.cover_shape(dims, ROI, stride) == \
        jax_sw.cover_shape(dims, ROI, stride)
    for x, y in zip(sw.bucketed_starts(dims, ROI, stride),
                    jax_sw.bucketed_starts(dims, ROI, stride)):
        np.testing.assert_array_equal(x, y)
    starts, valid, _ = sw.bucketed_starts(dims, ROI, stride)
    bucket = sw.bucket_shape(dims, ROI)
    np.testing.assert_array_equal(
        sw.gaussian_weight_acc(starts, valid.astype(np.int32), ROI, bucket),
        jax_sw.gaussian_weight_acc(starts, valid.astype(np.int32), ROI,
                                   bucket))


def _stand_in(xp):
    """Elementwise 3-class logits of the input (same on both sides)."""
    def fn(batch):
        v = batch[..., 0]
        return xp.stack([3.0 * v, 1.0 - v, 0.5 * v * v], axis=-1)
    return fn


@pytest.mark.parametrize("coverage", ["pad", "crop"])
@pytest.mark.parametrize("stride", STRIDES)
def test_stitched_probabilities_match_jax(stride, coverage):
    vol = np.random.default_rng(0).uniform(
        -1, 1, size=(40, 36, 20, 1)).astype(np.float32)
    if coverage == "crop":
        slices, _, _ = jax_sw.window_starts(vol.shape[:3], ROI, stride)
        vol = np.ascontiguousarray(vol[slices])
    jr = jax_sw.BucketedInference(_stand_in(jnp), ROI, None, 3,
                                  stride=stride, coverage=coverage,
                                  pad_value=-1.0)
    want = np.asarray(jr(vol))
    pr = sw.BucketedInference(_stand_in(torch), ROI, None, 3, stride=stride,
                              coverage=coverage, pad_value=-1.0,
                              device="cpu")
    got = pr(vol).numpy()
    assert got.shape == want.shape == (*vol.shape[:3], 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert pr.n_buckets == 1


def test_chunking_does_not_change_the_stitch():
    vol = np.random.default_rng(1).uniform(
        -1, 1, size=(40, 36, 20, 1)).astype(np.float32)
    whole = sw.BucketedInference(_stand_in(torch), ROI, None, 3,
                                 stride=0.5, coverage="pad",
                                 device="cpu")(vol)
    chunked = sw.BucketedInference(_stand_in(torch), ROI, 5, 3, stride=0.5,
                                   coverage="pad", device="cpu")(vol)
    torch.testing.assert_close(whole, chunked, atol=1e-6, rtol=0)


def test_device_windowing_matches_jax():
    raw = np.random.default_rng(2).integers(
        -1500, 2500, size=(6, 5, 4, 1)).astype(np.int16)
    want = np.asarray(jax_infer.device_scale_intensity()(jnp.asarray(raw)))
    got = infer.device_scale_intensity()(torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(got, want)


def test_resolve_io_pairs(tmp_path):
    (tmp_path / "in").mkdir()
    for name in ("b.nii.gz", "a.nii", "notes.txt"):
        (tmp_path / "in" / name).write_bytes(b"")
    pairs = infer.resolve_io([str(tmp_path / "in")], str(tmp_path / "out"))
    assert [(s.name, d.name) for s, d in pairs] == [
        ("a.nii", "a_seg.nii.gz"), ("b.nii.gz", "b_seg.nii.gz")]
    with pytest.raises(ValueError):
        infer.resolve_io([str(tmp_path / "in")], str(tmp_path / "x.nii.gz"))


@pytest.fixture(scope="module")
def tiny_jax():
    conf = tiny_conf()
    model, jconf, variables = jax_model(conf, seed=5)
    return conf, model, jconf, variables


def test_infer_main_end_to_end_matches_jax_serving(tmp_path, tiny_jax):
    conf, jm, jconf, variables = tiny_jax
    sd = export_state_dict(variables, jconf)
    ckpt = tmp_path / "model.pt"
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v))
                                     for k, v in sd.items()}}, ckpt)
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(yaml.safe_dump(conf))
    rng = np.random.default_rng(4)
    shape = (30, 26, 11)
    hu = rng.normal(0, 400, size=shape)
    hu[8:20, 6:18, 2:8] += 900.0
    vol = np.clip(hu, -1024, 3071).astype(np.int16)
    src = tmp_path / "ct.nii.gz"
    save_nifti(str(src), vol)
    out = tmp_path / "seg.nii.gz"

    infer.main(["--configs", str(cfg), "--ckpt", str(ckpt), "--input",
                str(src), "--output", str(out), "--stride-factor", "0.75",
                "--device", "cpu", "--chunk", "4"])
    labels, _ = load_nifti(str(out))
    assert labels.shape == shape

    def apply_fn(batch):
        return jm.apply(variables, batch, deterministic=True)["downstream"]

    runner = jax_sw.BucketedInference(
        apply_fn, tuple(conf["roi_size"]), 4, 2, stride=0.75,
        preprocess=jax_infer.device_scale_intensity(), coverage="pad",
        pad_value=-1000.0)
    probs = runner(vol[..., None])
    want = np.asarray(jnp.argmax(probs, axis=-1))
    assert (labels == want).mean() >= 0.999
    assert 0 < (want > 0).mean() < 1       # both classes present


def test_segment_volume_matches_jax(tiny_jax):
    from argparse import Namespace
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import ModelConfig
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        .torch_import import load_flax_variables
    conf, _, _, variables = tiny_jax
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    load_flax_variables(model, variables)
    rng = np.random.default_rng(9)
    vol = rng.uniform(0, 0.6, size=(30, 26, 11, 1)).astype(np.float32)
    vol[8:20, 6:18, 2:8] += 0.4
    got = infer.segment_volume(conf, model, vol)
    want = jax_infer.segment_volume(Namespace(**conf), variables, vol)
    assert got.shape == want.shape == vol.shape[:3]
    assert got.dtype == np.int16
    assert (got == want).mean() >= 0.999
    slices, _, _ = sw.window_starts(vol.shape[:3], tuple(conf["roi_size"]),
                                    None)
    inside = np.zeros(vol.shape[:3], bool)
    inside[slices] = True
    assert not got[~inside].any() and 0 < (got[inside] > 0).mean() < 1


def test_per_window_mode_matches_jax(tiny_jax):
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import ModelConfig
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        .torch_import import load_flax_variables
    conf, jm, jconf, variables = tiny_jax
    roi = tuple(conf["roi_size"])
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    load_flax_variables(model, variables)
    vol = np.random.default_rng(7).uniform(
        0, 1, size=(30, 36, 13, 1)).astype(np.float32)
    slices, _, _ = sw.window_starts(vol.shape[:3], roi, 0.5)
    vol = np.ascontiguousarray(vol[slices])
    runner = sw.BucketedInference(model.eval(), roi, 4, 2, stride=0.5,
                                  device="cpu", mode="per_window")
    with torch.inference_mode():
        got = runner(vol).numpy()
    _, starts, valid = runner.plan(vol.shape[:3])
    starts = starts[valid]
    assert got.shape == (len(starts), *roi) and len(starts) > 4

    def apply_fn(batch):
        return jm.apply(variables, batch, deterministic=True)["downstream"]

    run = jax_sw.make_sliding_window_fn(apply_fn, roi, 4, 2,
                                        mode="per_window", stride=0.5)
    padded, n = jax_sw.pad_starts(starts, 4)
    want = np.asarray(run(jnp.asarray(vol), jnp.asarray(padded),
                          jnp.asarray(n)))[:n]
    assert (got == want).mean() >= 0.999
    assert 0 < (want > 0).mean() < 1
    with pytest.raises(ValueError, match="mode"):
        sw.BucketedInference(model, roi, mode="stitch")


def test_watch_directory_serves_each_new_volume_once(tmp_path):
    import os
    import time
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import ModelConfig
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import init_weights
    conf = tiny_conf()
    model = init_weights(SwinUnetR(ModelConfig.from_mapping(conf)),
                         torch.Generator().manual_seed(0))
    inbox, out, ref = tmp_path / "in", tmp_path / "out", tmp_path / "ref"
    inbox.mkdir()
    rng = np.random.default_rng(8)
    old = time.time() - 60
    for name in ("a.nii.gz", "b.nii.gz"):
        save_nifti(str(inbox / name), rng.normal(
            0, 400, size=(20, 18, 9)).astype(np.int16))
        os.utime(inbox / name, (old, old))
    (inbox / "notes.txt").write_text("not a volume")
    assert infer.watch_directory(conf, model, inbox, out, interval=0.0,
                                 max_polls=2, stride=1.0) == (2, 0)
    # A volume still being written (too new) waits; served ones stay done.
    save_nifti(str(inbox / "c.nii.gz"), np.zeros((20, 18, 9), np.int16))
    assert infer.watch_directory(conf, model, inbox, out, interval=0.0,
                                 max_polls=1, stride=1.0) == (0, 0)
    assert sorted(p.name for p in out.iterdir()) == [
        "a_seg.nii.gz", "b_seg.nii.gz"]
    pairs = infer.resolve_io([str(inbox / "a.nii.gz"),
                              str(inbox / "b.nii.gz")], str(ref))
    assert infer.serve_volumes(conf, model, pairs, stride=1.0) == (2, 0)
    for name in ("a_seg.nii.gz", "b_seg.nii.gz"):
        np.testing.assert_array_equal(load_nifti(str(out / name))[0],
                                      load_nifti(str(ref / name))[0])
    with pytest.raises(SystemExit, match="single --input directory"):
        infer.main(["--ckpt", "x.pt", "--input", str(inbox), str(inbox),
                    "--output", str(out), "--watch", "--device", "cpu"])


def test_serve_volumes_counts_failures(tmp_path):
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import ModelConfig
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import init_weights
    conf = tiny_conf()
    model = init_weights(SwinUnetR(ModelConfig.from_mapping(conf)),
                         torch.Generator().manual_seed(0))
    good = tmp_path / "good.nii.gz"
    save_nifti(str(good), np.zeros((16, 16, 8), np.int16))
    bad = tmp_path / "bad.nii.gz"
    bad.write_bytes(b"not a nifti")
    done = infer.serve_volumes(conf, model, [(good, tmp_path / "g_seg.nii"),
                                             (bad, tmp_path / "b_seg.nii")],
                               stride=1.0)
    assert done == (1, 1)
    assert (tmp_path / "g_seg.nii").exists()


def test_serve_volumes_native_and_numpy_decoders_agree(tmp_path):
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import ModelConfig
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import init_weights
    conf = tiny_conf()
    model = init_weights(SwinUnetR(ModelConfig.from_mapping(conf)),
                         torch.Generator().manual_seed(1))
    src = tmp_path / "ct.nii.gz"
    save_nifti(str(src), np.random.default_rng(10).normal(
        0, 400, size=(22, 19, 9)).astype(np.float32))
    outs = []
    for native in (True, False):
        dst = tmp_path / f"seg_{native}.nii.gz"
        assert infer.serve_volumes(conf, model, [(src, dst)], stride=0.75,
                                   native=native) == (1, 0)
        outs.append(load_nifti(str(dst))[0])
    np.testing.assert_array_equal(outs[0], outs[1])


def _jax_conf(configs, **cli):
    """The JAX CLI's merged config (``utils/configs.py``)."""
    from medical_image_segmentation_with_visual_prompts_tpu.utils import \
        get_full_configs
    from argparse import Namespace
    base = dict(mode="fit", training_mode="downstream", configs=configs,
                backbone="swin_unetr", run_name="infer")
    for flag in ("load_ckpt_backbone", "save_ckpt_backbone",
                 "load_ckpt_prompt_tokens", "save_ckpt_prompt_tokens"):
        base[flag], base[flag + "_path"] = False, ""
    return vars(get_full_configs(Namespace(**{**base, **cli})))


def test_config_lookup_matches_jax_from_any_directory(tmp_path, monkeypatch):
    """An absolute path, a ``~`` path and a bare name under
    ``configurations/`` resolve, from another working directory, to the
    file the JAX CLI resolves."""
    from medical_image_segmentation_with_visual_prompts_tpu.utils import \
        configs as jax_configs
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        config
    home = tmp_path / "home"
    home.mkdir()
    (home / "mine.yml").write_text("alpha: 1\nroi_size: [8, 8, 4]\n")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.chdir(tmp_path)
    assert config.DEFAULT_CONFIG_DIR == jax_configs.DEFAULT_CONFIG_DIR
    cases = {str(home / "mine.yml"): home / "mine.yml",
             "~/mine.yml": home / "mine.yml",
             "example_configs.yml":
                 config.DEFAULT_CONFIG_DIR / "example_configs.yml"}
    for name, path in cases.items():
        assert config.config_path(name) == path
        with open(path) as f:
            more = yaml.safe_load(f)
        port, jax_conf = config.load_conf(name), _jax_conf(name)
        assert {k: port[k] for k in more} == {k: jax_conf[k] for k in more}
        assert {k: port[k] for k in more} == more


def test_config_yaml_wins_over_the_command_line(tmp_path):
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        config
    cfg = tmp_path / "c.yml"
    cfg.write_text("compute_dtype: float32\nuse_encoder_prompting: true\n")
    cli = dict(compute_dtype="bfloat16", use_encoder_prompting=False,
               chunk=4)
    port = config.load_conf(str(cfg), **cli)
    want = _jax_conf(str(cfg), **cli)
    assert port["compute_dtype"] == want["compute_dtype"] == "float32"
    assert port["use_encoder_prompting"] is want["use_encoder_prompting"] \
        is True
    assert port["chunk"] == want["chunk"] == 4


def test_config_lookup_raises_for_a_missing_file(tmp_path, monkeypatch):
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        config
    monkeypatch.chdir(tmp_path)
    for name in ("/nonexistent/path.yml", "no_such_config.yml"):
        with pytest.raises(FileNotFoundError):
            config.load_conf(name)
        with pytest.raises(FileNotFoundError):
            _jax_conf(name)
    with pytest.raises(SystemExit):    # the flag is gone: YAML sets dtype
        infer.main(["--configs", "example_configs.yml", "--ckpt", "m.pt",
                    "--input", "a.nii.gz", "--output", "b.nii.gz",
                    "--compute-dtype", "bfloat16"])
