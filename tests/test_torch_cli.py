"""PyTorch port: the training CLI (``main --mode fit|test``) against the
JAX package's, on ``configurations/tiny_cpu.yml`` with synthetic NIfTI
volumes, on the CPU.

* ``config.get_full_configs`` against the JAX one: the same merged
  config (run name at a fixed time, resolved checkpoint and log paths)
  and the same errors.
* One module fixture runs both CLIs: each fits epoch 0 and saves
  ``0001.ckpt``; each resumes epoch 1 from each package's file (dropout
  0); each tests the port's file in both protocols.  Resumed from the
  same file, the epoch's mean train and validation losses agree to 1e-4
  relative and the trainable tensors and BatchNorm statistics after it
  to 1e-4 of their largest magnitude (fp32 both; float reassociation
  through two AdamW steps).  Per-volume IoU and Dice of ``test()`` agree
  to 1e-3 absolute (argmax ties at reassociation noise may flip a few
  voxels), with the same ``+/-`` lines in the port's log.
* The port's summaries decode with the JAX TensorBoard reader and carry
  the JAX trainer's tags; a port-written ``scalars.jsonl`` converted by
  the port's ``utils.tb_events`` command decodes with the JAX reader to
  the same (tag, value, step), and a JAX-converted one with the port's.
* ``load_pseudo_bg_mask`` gives the JAX masks.
* Fault C5: the port's ``infer --ckpt`` serves the JAX trainer's
  checkpoint; its labels agree with the JAX model served by JAX
  ``BucketedInference`` from the same file on at least 99.9% of voxels.
* Phase 2: ``main --mode fit --training-mode supervised_learning_all``
  and ``self_supervised_learning_decoder`` on the CPU fit one epoch on
  synthetic volumes through their loaders and save the epoch-0 backbone
  checkpoint with its teacher.
* Phase 1: ``main --mode fit --training-mode
  self_supervised_learning_encoder`` on the CPU fits one epoch, saves the
  epoch-0 backbone checkpoint, and the port resumes it bit for bit.
* A non-flagship layout (``unetr_res_block: full``, the Swin output layer
  with its two prompt tokens): the JAX trainer's checkpoint serves
  through the port's ``infer --ckpt`` (the same 99.9%) and resumes in the
  port's trainer with the file's state bit for bit; the port's own
  checkpoint restores in the JAX package leaf for leaf, optimizer state
  included.
"""

import json
from argparse import Namespace
from datetime import datetime
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml
from PIL import Image

from medical_image_segmentation_with_visual_prompts_tpu import \
    infer as jax_infer
from medical_image_segmentation_with_visual_prompts_tpu.data.nifti import (
    load_nifti, save_nifti)
from medical_image_segmentation_with_visual_prompts_tpu.models import \
    ModelConfig as JaxModelConfig
from medical_image_segmentation_with_visual_prompts_tpu.parallel import \
    sliding_window as jax_sw
from medical_image_segmentation_with_visual_prompts_tpu.utils import \
    checkpoint as jax_ckpt
from medical_image_segmentation_with_visual_prompts_tpu.utils import \
    configs as jax_configs
from medical_image_segmentation_with_visual_prompts_tpu.utils import \
    initialization as jax_init
from medical_image_segmentation_with_visual_prompts_tpu.utils.tb_events \
    import decode_scalar_event, read_records
from medical_image_segmentation_with_visual_prompts_tpu.utils.torch_export \
    import export_state_dict
from medical_image_segmentation_with_visual_prompts_tpu_torch import (
    config, infer, main)
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    partition
from medical_image_segmentation_with_visual_prompts_tpu_torch.train import \
    MultiViewTrainer, StudentsTeacherTrainer
from medical_image_segmentation_with_visual_prompts_tpu_torch.train.common \
    import adamw_leaves
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    checkpoint as ckpt
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    initialization
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
    .torch_import import to_flax_variables
from test_torch_checkpoint import assert_trees_equal
from test_torch_swin_unetr import jax_model, tiny_conf

FLAGS = ("load_ckpt_backbone", "save_ckpt_backbone",
         "load_ckpt_prompt_tokens", "save_ckpt_prompt_tokens")
NOW = datetime(2026, 3, 4, 5, 6, 7)


def cli_args(**kw) -> Namespace:
    """The parsed command line of either package's ``main``."""
    args = {f: False for f in FLAGS}
    args.update({f + "_path": "" for f in FLAGS})
    args.update(mode="fit", training_mode="downstream",
                configs="tiny_cpu.yml", use_encoder_prompting=True,
                use_decoder_prompting=True, backbone="swin_unetr",
                run_name="")
    args.update(kw)
    return Namespace(**args)


def argv(args: Namespace) -> list:
    """``args`` as the port CLI's argument list, on the CPU."""
    out = ["--device", "cpu"]
    for key, value in vars(args).items():
        flag = "--" + key.replace("_", "-")
        if value is True:
            out.append(flag)
        elif value not in (False, ""):
            out += [flag, str(value)]
    return out


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """Checkpoint and log roots of both packages under ``tmp_path``."""
    for mod in (config, jax_configs):
        monkeypatch.setattr(mod, "DEFAULT_CKPT_DIR", tmp_path / "ckpts")
        monkeypatch.setattr(mod, "DEFAULT_ROOT_LOG_DIR", tmp_path / "logs")
    return tmp_path


def _both(args):
    return (vars(config.get_full_configs(args, now=NOW)),
            vars(jax_configs.get_full_configs(args, now=NOW)))


def test_get_full_configs_matches_jax(roots, monkeypatch):
    home = roots / "home"
    (home / "mine").mkdir(parents=True)
    (home / "mine" / "b.ckpt").write_bytes(b"")
    (roots / "ckpts" / "prompt_tokens" / "run").mkdir(parents=True)
    (roots / "abs.ckpt").write_bytes(b"")
    monkeypatch.setenv("HOME", str(home))
    cases = [
        cli_args(save_ckpt_prompt_tokens=True, run_name="x"),
        cli_args(save_ckpt_prompt_tokens=True,
                 save_ckpt_prompt_tokens_path="rel/dir",
                 save_ckpt_backbone=True,
                 save_ckpt_backbone_path="~/out"),
        cli_args(mode="test", load_ckpt_prompt_tokens=True,
                 load_ckpt_prompt_tokens_path="run",
                 load_ckpt_backbone=True,
                 load_ckpt_backbone_path="~/mine/b.ckpt",
                 configs="example_configs.yml"),
        cli_args(load_ckpt_backbone=True,
                 load_ckpt_backbone_path=str(roots / "abs.ckpt"),
                 save_ckpt_backbone=True,
                 save_ckpt_backbone_path=str(roots / "abs_out")),
    ]
    for args in cases:
        ours, theirs = _both(args)
        assert ours == theirs
        assert ours["run_name"] == (f"{args.mode}_swin_unetr_0304050607_"
                                    f"{args.run_name}")
        assert ours["log_dir"] == roots / "logs" / ours["run_name"]
    ours, _ = _both(cases[0])
    assert ours["save_ckpt_prompt_tokens_path"] == \
        roots / "ckpts" / "prompt_tokens" / ours["run_name"]
    ours, _ = _both(cases[2])
    assert ours["load_ckpt_prompt_tokens_path"] == \
        roots / "ckpts" / "prompt_tokens" / "run"
    assert ours["load_ckpt_backbone_path"] == home / "mine" / "b.ckpt"


@pytest.mark.parametrize("args,error", [
    (cli_args(configs="no_such.yml"), FileNotFoundError),
    (cli_args(load_ckpt_backbone=True), ValueError),
    (cli_args(load_ckpt_prompt_tokens=True), ValueError),
    (cli_args(load_ckpt_prompt_tokens=True,
              load_ckpt_prompt_tokens_path="missing.ckpt"),
     FileNotFoundError),
    (cli_args(load_ckpt_backbone=True, load_ckpt_backbone_path="/no/x"),
     FileNotFoundError),
])
def test_get_full_configs_raises_as_jax_does(roots, args, error):
    with pytest.raises(error) as ours:
        config.get_full_configs(args)
    with pytest.raises(error) as theirs:
        jax_configs.get_full_configs(args)
    assert str(ours.value) == str(theirs.value)


def test_other_training_modes_name_their_roadmap_item(roots, monkeypatch):
    """The phase-1 mode builds the multi-view trainer (its model with the
    three proxy heads); the four phase-2 modes build the students-teacher
    trainer; with ``view: true`` a one-epoch fit of each trainer writes
    its PNG panels (under ``MIVP_VIEW_DIR``); an unknown mode raises."""
    hp = config.get_full_configs(cli_args(
        training_mode="self_supervised_learning_encoder"))
    tr = initialization.select_trainer(
        hp, initialization.select_backbone(hp), None, None, None, None,
        "cpu")
    assert isinstance(tr, MultiViewTrainer)
    assert sorted(tr.model.extra_heads) == [
        "contrastive_coding", "reconstruction", "rotation_prediction"]
    assert tr.loss_names == ["rec", "rot", "con", "tot"]
    for mode in initialization.PHASE2_MODES:
        hp = config.get_full_configs(cli_args(training_mode=mode))
        tr = initialization.select_trainer(
            hp, initialization.select_backbone(hp), None, None, None, None,
            "cpu")
        assert isinstance(tr, StudentsTeacherTrainer)
        assert tr.supervised == mode.startswith("supervised")
    root = roots
    views = root / "views"
    monkeypatch.setenv("MIVP_VIEW_DIR", str(views))
    _volumes(root, "view", [(20 + k, 18, 9) for k in range(3)], 4)
    data = {f"{kind}_dir_{use}": str(root / f"view_{short}")
            for kind, short in (("image", "img"), ("mask", "msk"))
            for use in ("pretrain", "supervised", "downstream")}
    conf = tiny_conf(view=True, active_labels_downstream=[0, 2], **data)
    for key in ("training_mode", "use_encoder_prompting",
                "use_decoder_prompting"):
        conf.pop(key)
    (root / "view.yml").write_text(yaml.safe_dump(conf))
    phase1 = "self_supervised_learning_encoder"
    for mode, sub, kind in (("downstream", "seg_new", "seg"),
                            ("supervised_learning_decoder", "prt", "prt"),
                            (phase1, "rec", "rec")):
        args = cli_args(training_mode=mode, configs=str(root / "view.yml"),
                        use_decoder_prompting=mode != phase1)
        parsed = main.build_parser().parse_args(argv(args))
        tr = main.main(parsed.mode, config.get_full_configs(parsed),
                       parsed.device)
        # 3 volumes split 0.8: 2 train x 2 crops = 2 steps; step 0 drawn,
        # 2 rows (per model for prt) of 4 slices of 128x128.
        pngs = list((views / sub).glob("*.png"))
        assert tr.view and len(pngs) == 1
        assert pngs[0].name.startswith("epoch0_step0_case")
        assert pngs[0].name.endswith(f".nii_{kind}.png")
        rows = 2 * (1 + tr.n_students) if kind == "prt" else 2
        with Image.open(pngs[0]) as png:
            assert png.size == (512, rows * 128)
    hp = config.get_full_configs(cli_args(training_mode="phase_three"))
    with pytest.raises(NotImplementedError, match="not available"):
        initialization.setup_fitting(hp, "cpu")


@pytest.mark.parametrize("mode", ["supervised_learning_all",
                                  "self_supervised_learning_decoder"])
def test_phase2_fit_runs_one_epoch_through_main(roots, mode):
    root = roots
    _volumes(root, "pre", [(20 + k, 18, 9) for k in range(3)], 2)
    conf = tiny_conf(image_dir_pretrain=str(root / "pre_img"),
                     image_dir_supervised=str(root / "pre_img"),
                     mask_dir_supervised=str(root / "pre_msk"),
                     attn_drop=0.1, proj_drop=0.1)
    for key in ("training_mode", "use_encoder_prompting",
                "use_decoder_prompting"):
        conf.pop(key)
    (root / "phase2.yml").write_text(yaml.safe_dump(conf))
    args = cli_args(training_mode=mode, configs=str(root / "phase2.yml"),
                    run_name="p2", save_ckpt_backbone=True)
    parsed = main.build_parser().parse_args(argv(args))
    assert parsed.device == "cpu"
    tr = main.main(parsed.mode, config.get_full_configs(parsed),
                   parsed.device)
    # 3 volumes split 0.8: 2 train x 2 crops = 2 steps, 1 val = 1 step.
    assert isinstance(tr, StudentsTeacherTrainer)
    assert len(tr.losses) == tr.step_count == 2 and len(tr.val_losses) == 1
    names = ["prt", "seg", "tot"] if mode.startswith("supervised") \
        else ["prt", "tot"]
    assert all(sorted(p) == names and all(np.isfinite(list(p.values())))
               for p in tr.losses + tr.val_losses)
    saved = ckpt.load_checkpoint(tr.save_ckpt_path / "0001.ckpt")
    assert "teacher_state_dict" in saved
    assert int(saved["scheduler_state_dict"]["step"]) == 2
    tags = {r["tag"] for r in _scalars(tr.hparams.summary_dir)}
    assert {f"{k}_loss/{n}" for k in ("train", "val") for n in names} | \
        {"perf/step_ms"} <= tags
    assert ("val_metric/seg" in tags) == mode.startswith("supervised")
    log = (Path(tr.hparams.log_dir) / "log.txt").read_text()
    assert "Learning rate in step 0 epoch 0: 0.00025." in log
    assert "Contrastive training loss in step 0 epoch 0" in log


def test_phase1_fit_runs_one_epoch_through_main(roots):
    """``main --mode fit --training-mode self_supervised_learning_encoder
    --device cpu`` fits epoch 0 on synthetic volumes through the
    self-supervised loaders, saves ``0001.ckpt`` (no teacher), and the
    port resumes it bit for bit (model, optimizer, step, epoch)."""
    root = roots
    _volumes(root, "pre", [(20 + k, 18, 9) for k in range(3)], 3)
    conf = tiny_conf(image_dir_pretrain=str(root / "pre_img"),
                     attn_drop=0.1, proj_drop=0.1)
    for key in ("training_mode", "use_encoder_prompting",
                "use_decoder_prompting"):
        conf.pop(key)
    (root / "phase1.yml").write_text(yaml.safe_dump(conf))
    args = cli_args(training_mode="self_supervised_learning_encoder",
                    configs=str(root / "phase1.yml"), run_name="p1",
                    use_decoder_prompting=False, save_ckpt_backbone=True)
    parsed = main.build_parser().parse_args(argv(args))
    tr = main.main(parsed.mode, config.get_full_configs(parsed),
                   parsed.device)
    # 3 volumes split 0.8: 2 train x 2 crops = 2 steps, 1 val = 1 step.
    assert isinstance(tr, MultiViewTrainer)
    assert len(tr.losses) == tr.step_count == 2 and len(tr.val_losses) == 1
    names = ["con", "rec", "rot", "tot"]
    assert all(sorted(p) == names and all(np.isfinite(list(p.values())))
               for p in tr.losses + tr.val_losses)
    saved = ckpt.load_checkpoint(tr.save_ckpt_path / "0001.ckpt")
    assert "teacher_state_dict" not in saved
    assert int(saved["scheduler_state_dict"]["step"]) == 2
    assert_trees_equal(saved["model_state_dict"],
                       to_flax_variables(tr.model))
    tags = {r["tag"] for r in _scalars(tr.hparams.summary_dir)}
    assert {f"{k}_loss/{n}" for k in ("train", "val") for n in names} | \
        {"perf/step_ms"} <= tags
    log = (Path(tr.hparams.log_dir) / "log.txt").read_text()
    assert "Learning rate in step 0 epoch 0: 0.00025." in log
    assert "Rotation prediction training loss in step 0 epoch 0" in log
    resume = config.get_full_configs(main.build_parser().parse_args(argv(
        cli_args(training_mode="self_supervised_learning_encoder",
                 configs=str(root / "phase1.yml"), run_name="p1r",
                 use_decoder_prompting=False, load_ckpt_backbone=True,
                 load_ckpt_backbone_path=str(tr.save_ckpt_path
                                             / "0001.ckpt")))))
    again = initialization.select_trainer(
        resume, initialization.select_backbone(resume), None, None, None,
        None, "cpu")
    assert again.prepare_fit() == 1 and again.step_count == 2
    assert_trees_equal(to_flax_variables(again.model),
                       saved["model_state_dict"])
    from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
        .common import grouped_adamw_leaves
    assert_trees_equal(grouped_adamw_leaves(again.optimizer, again.model, 2),
                       saved["optimizer_state_dict"]["__flat_leaves__"])


# ------------------------------------------------- the two CLIs end to end

def _volumes(root: Path, sub: str, shapes, seed: int) -> None:
    rng = np.random.default_rng(seed)
    (root / f"{sub}_img").mkdir()
    (root / f"{sub}_msk").mkdir()
    for k, shape in enumerate(shapes):
        hu = rng.normal(-100.0, 400.0, shape)
        organ = np.zeros(shape, bool)
        organ[3:-3, 4:-4, 2:-2] = rng.random(organ[3:-3, 4:-4, 2:-2].shape) \
            < 0.7
        hu[organ] += 600.0
        mask = np.where(organ, 2, rng.integers(0, 2, shape))
        save_nifti(str(root / f"{sub}_img" / f"case{k}.nii.gz"),
                   np.clip(hu, -1024, 3071).astype(np.int16))
        save_nifti(str(root / f"{sub}_msk" / f"case{k}.nii.gz"),
                   mask.astype(np.int16))


def _scalars(summary_dir) -> list:
    with open(Path(summary_dir) / "scalars.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    _volumes(root, "train", [(20 + k, 18, 9) for k in range(3)], 0)
    _volumes(root, "test", [(34, 26, 13), (30, 27, 12)], 1)

    def yml(name, **over):
        conf = tiny_conf(
            image_dir_downstream=str(root / "train_img"),
            mask_dir_downstream=str(root / "train_msk"),
            image_dir_test=str(root / "test_img"),
            mask_dir_test=str(root / "test_msk"), **over)
        for key in ("training_mode", "use_encoder_prompting",
                    "use_decoder_prompting"):
            conf.pop(key)           # from the command line
        (root / f"{name}.yml").write_text(yaml.safe_dump(conf))
        return str(root / f"{name}.yml")

    out = {"root": root}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (config, jax_configs):
            mp.setattr(mod, "DEFAULT_CKPT_DIR", root / "ckpts")
            mp.setattr(mod, "DEFAULT_ROOT_LOG_DIR", root / "logs")

        def fit(pkg, run, configs, **kw):
            args = cli_args(configs=configs, run_name=run, **kw)
            if pkg == "port":        # main.cli's steps, keeping the trainer
                parsed = main.build_parser().parse_args(argv(args))
                return main.main(parsed.mode, config.get_full_configs(parsed),
                                 parsed.device)
            tr = jax_init.setup_fitting(jax_configs.get_full_configs(args))
            tr.train()
            return tr

        fit0 = yml("fit0", max_epochs_downstream=0)
        for pkg in ("jax", "port"):
            out[f"{pkg}0"] = fit(
                pkg, f"{pkg}0", fit0, save_ckpt_prompt_tokens=True,
                save_ckpt_prompt_tokens_path=str(root / f"{pkg}_ckpt"))
        fit1 = yml("fit1", max_epochs_downstream=1)
        for src in ("jax", "port"):
            for pkg in ("jax", "port"):
                out[f"{pkg}_from_{src}"] = fit(
                    pkg, f"{pkg}_from_{src}", fit1,
                    load_ckpt_prompt_tokens=True,
                    load_ckpt_prompt_tokens_path=str(
                        root / f"{src}_ckpt" / "0001.ckpt"))
        for blend in ("none", "gaussian"):
            args = cli_args(mode="test", configs=yml(
                f"test_{blend}", test_blending=blend),
                run_name=f"test_{blend}", load_ckpt_prompt_tokens=True,
                load_ckpt_prompt_tokens_path=str(root / "port_ckpt"))
            tr = jax_init.setup_testing(jax_configs.get_full_configs(args))
            out[f"jax_test_{blend}"] = tr.test()
            out[f"port_test_{blend}"] = main.main(
                "test", config.get_full_configs(args), device="cpu")
    return out


def test_fit_saves_every_20_epochs_from_epoch_0(runs):
    root = runs["root"]
    for pkg in ("jax", "port"):
        assert sorted(p.name for p in (root / f"{pkg}_ckpt").iterdir()) == \
            ["0001.ckpt"]
        saved = ckpt.load_checkpoint(root / f"{pkg}_ckpt")
        assert saved["current_epoch"] == 1
        assert int(saved["scheduler_state_dict"]["epoch"]) == 1
    assert len(runs["port0"].losses) == 2
    assert all(np.isfinite(runs["port0"].losses))


@pytest.mark.parametrize("src", ["jax", "port"])
def test_resume_from_either_checkpoint_matches_jax(runs, src):
    jtr, ptr = runs[f"jax_from_{src}"], runs[f"port_from_{src}"]
    assert ptr.start_epoch == 1 and len(ptr.losses) == 2
    want = {(r["tag"], r["step"]): r["value"]
            for r in _scalars(jtr.hparams.summary_dir)}
    got = {(r["tag"], r["step"]): r["value"]
           for r in _scalars(ptr.hparams.summary_dir)}
    for tag in ("train_loss/seg", "train_loss/tot", "val_loss/seg"):
        assert set(k[1] for k in got if k[0] == tag) == {1}
        np.testing.assert_allclose(got[(tag, 1)], want[(tag, 1)],
                                   rtol=1e-4, err_msg=tag)
    jsd = export_state_dict(jtr.final_state, JaxModelConfig.from_namespace(
        jtr.hparams))
    own = ptr.model.state_dict()
    labels = partition.downstream_labels(ptr.model_conf)
    trainable = {n for n, _ in ptr.model.named_parameters()
                 if partition.label_of(n) in labels}
    checked = [k for k in own if k in trainable
               or k.endswith(("running_mean", "running_var"))]
    assert len(checked) > len(trainable) > 0
    for k in checked:
        scale = float(np.abs(jsd[k]).max())
        err = float(np.abs(own[k].numpy() - jsd[k]).max())
        assert err <= 1e-4 * scale, (k, err, scale)


def test_resume_restores_the_saved_state_exactly(runs):
    """Before its first step the resumed trainer holds the file's model
    and optimizer state bit for bit."""
    root = runs["root"]
    for src in ("jax", "port"):
        saved = ckpt.load_checkpoint(root / f"{src}_ckpt" / "0001.ckpt")
        hp = Namespace(**vars(runs[f"port_from_{src}"].hparams))
        tr = initialization.select_trainer(
            hp, initialization.select_backbone(hp), None, None, None, None,
            "cpu")
        assert tr.prepare_fit() == 1
        assert_trees_equal(to_flax_variables(tr.model),
                           saved["model_state_dict"])
        assert_trees_equal(adamw_leaves(tr.optimizer, tr.model),
                           saved["optimizer_state_dict"]["__flat_leaves__"])


@pytest.mark.parametrize("blend", ["none", "gaussian"])
def test_test_protocols_match_jax(runs, blend):
    want, tr = runs[f"jax_test_{blend}"], runs[f"port_test_{blend}"]
    got = tr.metric_vals
    assert set(got) == set(want) == {"iou", "dcc"}
    for key in want:
        assert len(got[key]) == len(want[key]) == 2
        np.testing.assert_allclose(got[key], want[key], atol=1e-3, rtol=0)
        assert all(0.0 < v < 1.0 for v in got[key])
    # The labels the protocol yields: the 12 windows of the 32x24x12 crop
    # of case0 per window, the stitched crop whole.
    volumes = tr._test_windows() if blend == "none" else tr._test_gaussian()
    labels = {name: pred.numpy() for name, _, pred in volumes}["case0.nii"]
    assert labels.shape == ((12, 16, 16, 8) if blend == "none"
                            else (32, 24, 12)), labels.shape
    assert labels.dtype == np.uint8 and set(np.unique(labels)) <= {0, 1}
    log = (Path(tr.hparams.log_dir) / "log.txt").read_text()
    run = tr.hparams.run_name
    for key in ("iou", "dcc"):
        mean = float(np.mean(got[key]))
        assert f"{run}: {key}: {mean:.4f} +/- " in log, key


def test_summaries_decode_with_the_jax_reader(runs):
    ptr, jtr = runs["port0"], runs["jax0"]
    summary = Path(ptr.hparams.summary_dir)
    events, = summary.glob("events.out.tfevents.*")
    decoded = [decode_scalar_event(p) for p in read_records(events)]
    assert decoded[0] is None                  # the file_version record
    rows = _scalars(summary)
    assert [(t, s) for t, _, s, _ in decoded[1:]] == \
        [(r["tag"], r["step"]) for r in rows]
    np.testing.assert_allclose([v for _, v, _, _ in decoded[1:]],
                               [r["value"] for r in rows], rtol=1e-6)
    tags = {r["tag"] for r in rows}
    assert tags == {r["tag"] for r in _scalars(jtr.hparams.summary_dir)}
    assert {"perf/step_ms", "train_loss/seg", "train_metric/seg",
            "val_loss/seg", "val_metric/seg"} <= tags


def test_tb_events_command_round_trips_with_jax(tmp_path, monkeypatch):
    import subprocess
    import sys
    from medical_image_segmentation_with_visual_prompts_tpu.utils import \
        tb_events as jax_tb
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import loggers, tb_events
    monkeypatch.setenv("MIVP_TENSORBOARD", "0")
    rows = [("train_loss/seg", 0.75, 0), ("perf/step_ms", 123.5, 0),
            ("train_loss/seg", 0.5, 1), ("val_metric/seg", 1e-8, 7)]
    for side in ("port", "jax"):
        summary = tmp_path / side
        writer = loggers.get_summary_writer(summary)
        for tag, value, step in rows:
            writer.add_scalar(tag, value, step)
        writer.close()
        assert not list(summary.glob("events.out.tfevents.*"))
    out = subprocess.run(
        [sys.executable, "-m", tb_events.__name__, str(tmp_path / "port")],
        cwd=Path(__file__).resolve().parent.parent, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    port_events = Path(out.stdout.strip())
    jax_events = jax_tb.convert_jsonl(tmp_path / "jax")
    for path, read, decode in (
            (port_events, jax_tb.read_records, jax_tb.decode_scalar_event),
            (jax_events, tb_events.read_records,
             tb_events.decode_scalar_event)):
        assert path.parent.exists() and path.name.startswith(
            "events.out.tfevents.")
        decoded = [decode(p) for p in read(path)]
        assert decoded[0] is None              # the file-version record
        assert [(t, s) for t, _, s, _ in decoded[1:]] == \
            [(t, s) for t, _, s in rows]
        np.testing.assert_array_equal(
            [v for _, v, _, _ in decoded[1:]],
            np.float32([v for _, v, _ in rows]))
    assert tb_events.file_version_event(1.5) == \
        jax_tb.file_version_event(1.5)


def test_load_pseudo_bg_mask_matches_jax():
    from medical_image_segmentation_with_visual_prompts_tpu.data import \
        transforms as jax_tf
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import transforms
    rng = np.random.default_rng(11)
    sample = {"image": rng.uniform(0, 0.005, (6, 5, 4, 1)).astype(
        np.float32), "image_st_0": rng.uniform(0, 0.005, (4, 4, 4, 1)),
        "mask": np.ones((6, 5, 4, 1))}
    got, want = transforms.load_pseudo_bg_mask(sample), \
        jax_tf.load_pseudo_bg_mask(sample)
    assert sorted(got) == sorted(want) == sorted(
        [*sample, "pseudo_bg", "pseudo_bg_st_0"])
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_infer_serves_a_jax_trainer_checkpoint(runs, tmp_path):
    """Fault C5: ``infer --ckpt`` reads the JAX trainer's checkpoint."""
    root = runs["root"]
    path = root / "jax_ckpt" / "0001.ckpt"
    cfg = str(root / "fit0.yml")
    src = root / "test_img" / "case0.nii.gz"
    out = tmp_path / "seg.nii.gz"
    infer.main(["--configs", cfg, "--ckpt", str(path), "--input", str(src),
                "--output", str(out), "--stride-factor", "0.75", "--device",
                "cpu", "--chunk", "4", "--use-encoder-prompting",
                "--use-decoder-prompting"])
    labels, _ = load_nifti(str(out))
    conf = tiny_conf(**yaml.safe_load(open(cfg)))
    jm, _, template = jax_model(conf)
    variables = jax_ckpt.restore_like(
        template, jax_ckpt.load_checkpoint(path)["model_state_dict"])

    def apply_fn(batch):
        return jm.apply(variables, batch, deterministic=True)["downstream"]

    vol, _ = load_nifti(str(src))
    runner = jax_sw.BucketedInference(
        apply_fn, tuple(conf["roi_size"]), 4, 2, stride=0.75,
        preprocess=jax_infer.device_scale_intensity(), coverage="pad",
        pad_value=-1000.0)
    want = np.asarray(jnp.argmax(runner(vol[..., None]), axis=-1))
    assert labels.shape == want.shape == vol.shape
    assert (labels == want).mean() >= 0.999
    assert 0 < (want > 0).mean() < 1


def test_module_entry_point_tests_a_checkpoint(runs, tmp_path):
    """``python -m ...main --mode test`` in a fresh process, on the CPU,
    with the logs moved by MIVP_LOG_DIR."""
    import os
    import subprocess
    import sys
    root = runs["root"]
    env = {**os.environ, "MIVP_LOG_DIR": str(tmp_path),
           "MIVP_TENSORBOARD": "0"}
    out = subprocess.run(
        [sys.executable, "-m",
         "medical_image_segmentation_with_visual_prompts_tpu_torch.main",
         "--mode", "test", "--training-mode", "downstream", "--configs",
         str(root / "test_none.yml"), "--use-encoder-prompting",
         "--use-decoder-prompting", "--load-ckpt-prompt-tokens",
         "--load-ckpt-prompt-tokens-path", str(root / "port_ckpt"),
         "--run-name", "entry", "--device", "cpu"],
        cwd=Path(__file__).resolve().parent.parent, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    log, = tmp_path.glob("test_swin_unetr_*_entry/log.txt")
    want = runs["port_test_none"].metric_vals
    for key in ("iou", "dcc"):
        assert f": {key}: {np.mean(want[key]):.4f} +/- " in log.read_text()
    assert not list(tmp_path.glob("*/summary/events.out.tfevents.*"))


def test_full_swin_checkpoints_cross_both_ways(runs, tmp_path, monkeypatch):
    from medical_image_segmentation_with_visual_prompts_tpu.models import \
        partition as jax_partition
    from test_torch_checkpoint import _jax_opt_state
    root = runs["root"]
    for mod in (config, jax_configs):
        monkeypatch.setattr(mod, "DEFAULT_CKPT_DIR", tmp_path / "ckpts")
        monkeypatch.setattr(mod, "DEFAULT_ROOT_LOG_DIR", tmp_path / "logs")

    def yml(name, **over):
        conf = tiny_conf(
            image_dir_downstream=str(root / "train_img"),
            mask_dir_downstream=str(root / "train_msk"),
            image_dir_test=str(root / "test_img"),
            mask_dir_test=str(root / "test_msk"), unetr_res_block="full",
            unetr_up_block="swin", **over)
        for key in ("training_mode", "use_encoder_prompting",
                    "use_decoder_prompting"):
            conf.pop(key)
        (tmp_path / f"{name}.yml").write_text(yaml.safe_dump(conf))
        return str(tmp_path / f"{name}.yml")

    fit0, fit1 = (yml(f"full{e}", max_epochs_downstream=e) for e in (0, 1))
    # 1. The JAX trainer fits epoch 0 and saves 0001.ckpt.
    jtr = jax_init.setup_fitting(jax_configs.get_full_configs(cli_args(
        configs=fit0, run_name="jfull", save_ckpt_prompt_tokens=True,
        save_ckpt_prompt_tokens_path=str(tmp_path / "jax_ckpt"))))
    jtr.train()
    jfile = tmp_path / "jax_ckpt" / "0001.ckpt"
    # 2. The port serves it.
    src = root / "test_img" / "case0.nii.gz"
    out = tmp_path / "seg.nii.gz"
    infer.main(["--configs", fit0, "--ckpt", str(jfile), "--input",
                str(src), "--output", str(out), "--stride-factor", "0.75",
                "--device", "cpu", "--chunk", "4", "--use-encoder-prompting",
                "--use-decoder-prompting"])
    labels, _ = load_nifti(str(out))
    conf = tiny_conf(**yaml.safe_load(open(fit0)))
    jm, jconf, template = jax_model(conf)
    variables = jax_ckpt.restore_like(
        template, jax_ckpt.load_checkpoint(jfile)["model_state_dict"])
    assert "prompt_tokens_out_0" in variables["params"]

    def apply_fn(batch):
        return jm.apply(variables, batch, deterministic=True)["downstream"]

    vol, _ = load_nifti(str(src))
    runner = jax_sw.BucketedInference(
        apply_fn, tuple(conf["roi_size"]), 4, 2, stride=0.75,
        preprocess=jax_infer.device_scale_intensity(), coverage="pad",
        pad_value=-1000.0)
    want = np.asarray(jnp.argmax(runner(vol[..., None]), axis=-1))
    assert labels.shape == want.shape == vol.shape
    assert (labels == want).mean() >= 0.999
    # 3. The port resumes from it: the file's state bit for bit, then an
    # epoch whose steps move the output layer's tokens.
    args = cli_args(configs=fit1, run_name="pfull",
                    load_ckpt_prompt_tokens=True,
                    load_ckpt_prompt_tokens_path=str(jfile))
    hp = config.get_full_configs(args)
    saved = ckpt.load_checkpoint(jfile)
    resumed = initialization.select_trainer(
        hp, initialization.select_backbone(hp), None, None, None, None,
        "cpu")
    assert resumed.prepare_fit() == 1
    assert_trees_equal(to_flax_variables(resumed.model),
                       saved["model_state_dict"])
    assert_trees_equal(adamw_leaves(resumed.optimizer, resumed.model),
                       saved["optimizer_state_dict"]["__flat_leaves__"])
    before = resumed.model.prompt_tokens.out[0].detach().clone()
    fitted = main.main("fit", config.get_full_configs(args), "cpu")
    assert fitted.start_epoch == 1 and len(fitted.losses) == 2
    assert all(np.isfinite(fitted.losses))
    assert (fitted.model.prompt_tokens.out[0].detach() - before).abs().max() \
        > 0
    # 4. The port's own checkpoint restores in the JAX package.
    pfit = main.main("fit", config.get_full_configs(cli_args(
        configs=fit0, run_name="pfull0", save_ckpt_prompt_tokens=True,
        save_ckpt_prompt_tokens_path=str(tmp_path / "port_ckpt"))), "cpu")
    pfile = jax_ckpt.load_checkpoint(tmp_path / "port_ckpt" / "0001.ckpt")
    back = jax_ckpt.restore_like(template, pfile["model_state_dict"])
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, back),
                       to_flax_variables(pfit.model))
    _, _, state = _jax_opt_state({**conf, "weight_decay_downstream": 0.0},
                                 jconf, template)
    leaves = jax_ckpt.restore_like(
        jax.tree_util.tree_leaves(state),
        pfile["optimizer_state_dict"]["__flat_leaves__"])
    assert int(leaves[0]) == len(pfit.losses)
    trainable, _ = jax_partition.split_params(
        template["params"], jax_partition.trainable_labels(jconf))
    assert "prompt_tokens_out_1" in trainable
