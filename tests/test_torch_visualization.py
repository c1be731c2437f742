"""PyTorch port: the ``view`` PNG dumps against the JAX package's.

* Each of the four view functions on the same seeded arrays as the JAX
  one (its PNGs read with PIL): the same subdirectory and file name, the
  same panel shape, decoded pixels within 1 grey level and at least 99%
  equal (the port's numpy resize is PIL's ``F``-mode resize, so they are
  equal here).
* The resize against PIL's at 128x128 (bicubic and nearest, up and
  down, sizes the trainers give it), bit for bit; the PNG writer read
  by PIL; ``MIVP_VIEW_DIR`` read at each call.
* ``SegmentationTrainer.test()`` with ``view: true`` draws the first
  chunk of each test volume (per-window protocol), as the JAX trainer.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import medical_image_segmentation_with_visual_prompts_tpu.utils \
    .visualization as jax_vis
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    visualization as vis


def _arrays(seed: int):
    rng = np.random.default_rng(seed)
    img = rng.random((2, 40, 24, 8, 1)).astype(np.float32)
    rec = (rng.random((2, 40, 24, 8, 1)) * 1.2 - 0.1).astype(np.float32)
    logits = rng.random((2, 20, 36, 8, 3)).astype(np.float32)
    tgt = rng.integers(0, 3, (2, 20, 36, 8, 1)).astype(np.float32)
    lat = rng.random((2, 16, 16, 4, 6)).astype(np.float32)
    lat_st = [rng.random((2, 12, 12, 4, 6)).astype(np.float32),
              rng.random((2, 10, 10, 4, 6)).astype(np.float32)]
    img_st = [rng.random((2, 96, 96, 8, 1)).astype(np.float32),
              rng.random((2, 80, 80, 8, 1)).astype(np.float32)]
    return img, rec, logits, tgt, lat, lat_st, img_st


CALLS = {
    "reconstruction": lambda m, a: m.view_reconstruction(
        ["case0"], 4, 1, 5, ori_img=a[0], rec_img=a[1]),
    "prototype": lambda m, a: m.view_prototype(
        "case1", 4, 0, 10, 6, prt1=a[4], prt2=a[4][::-1]),
    "prototype_students_teacher":
        lambda m, a: m.view_prototype_students_teacher(
            ["case2"], 4, 2, 0, 6, prt_tch=a[4], img_tch=a[0],
            prt_sts=a[5], img_sts=a[6]),
    "segmentation": lambda m, a: m.view_segmentation(
        ["case3"], 4, 0, 3, seg_pred=a[2], seg_target=a[3], img=a[0],
        n_classes=3),
}


@pytest.mark.parametrize("view", sorted(CALLS))
def test_view_matches_jax(view, tmp_path, monkeypatch):
    arrays = _arrays(len(view))
    monkeypatch.setattr(jax_vis, "_OUT_ROOT", tmp_path / "jax")
    monkeypatch.setenv("MIVP_VIEW_DIR", str(tmp_path / "port"))
    want_path = CALLS[view](jax_vis, arrays)
    got_path = CALLS[view](vis, [torch.from_numpy(a) if i == 2 else a
                                 for i, a in enumerate(arrays)])
    assert got_path.relative_to(tmp_path / "port") == \
        want_path.relative_to(tmp_path / "jax")
    want = np.asarray(Image.open(want_path))
    got = np.asarray(Image.open(got_path))
    assert got.shape == want.shape and got.shape[1] == 4 * 128
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("shape", [(16, 16), (40, 24), (96, 80), (320, 320),
                                   (128, 64), (7, 300)])
def test_resize_is_pils(shape):
    a = (np.random.default_rng(sum(shape)).random(shape) * 300 - 20) \
        .astype(np.float32)
    for nearest, mode in ((False, Image.BICUBIC), (True, Image.NEAREST)):
        want = np.asarray(Image.fromarray(a).resize((128, 128), mode))
        assert np.array_equal(vis.resize(a, nearest), want)


def test_png_writer_and_view_root(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (30, 50)).astype(np.uint8)
    vis.write_png(tmp_path / "a.png", img)
    with Image.open(tmp_path / "a.png") as png:
        assert png.mode == "L"
        assert np.array_equal(np.asarray(png), img)
    monkeypatch.delenv("MIVP_VIEW_DIR", raising=False)
    assert vis.out_root() == vis.Path("~/image_outputs")
    monkeypatch.setenv("MIVP_VIEW_DIR", str(tmp_path))
    assert vis.out_root() == tmp_path


def test_segmentation_test_views_each_volumes_first_chunk(tmp_path,
                                                          monkeypatch):
    from argparse import Namespace

    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        config, main
    from test_torch_cli import _volumes, argv, cli_args
    from test_torch_swin_unetr import tiny_conf
    import yaml
    for attr in ("DEFAULT_CKPT_DIR", "DEFAULT_ROOT_LOG_DIR"):
        monkeypatch.setattr(config, attr, tmp_path / attr)
    monkeypatch.setenv("MIVP_VIEW_DIR", str(tmp_path / "views"))
    _volumes(tmp_path, "t", [(20 + k, 18, 9) for k in range(2)], 5)
    conf = tiny_conf(view=True, image_dir_test=str(tmp_path / "t_img"),
                     mask_dir_test=str(tmp_path / "t_msk"),
                     active_labels_downstream=[0, 2])
    (tmp_path / "t.yml").write_text(yaml.safe_dump(conf))
    args = main.build_parser().parse_args(argv(cli_args(
        mode="test", configs=str(tmp_path / "t.yml"))))
    tr = main.main(args.mode, config.get_full_configs(args), args.device)
    assert isinstance(tr.hparams, Namespace)
    assert len(tr.metric_vals["iou"]) == 2
    names = sorted(p.name for p in (tmp_path / "views" / "seg_new").iterdir())
    assert names == ["epoch0_step0_case0.nii_seg.png",
                     "epoch0_step1_case1.nii_seg.png"]
    for name in names:     # prediction, target and image rows
        png = Image.open(tmp_path / "views" / "seg_new" / name)
        assert np.asarray(png).shape == (3 * 128, 4 * 128)
