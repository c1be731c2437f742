"""PyTorch port: ``train/common.py::StepProfiler``, the step timing and
the ``profile_dir`` trace of the three trainers.

* The profiler alone: every step timed, ``mean_ms`` over the last steps,
  one Chrome trace holding global steps 2-6 and no other, the rank in
  the file name under a data group, and a trace that a short run leaves
  open written by ``close``.
* Through ``main --mode fit`` on ``configurations/tiny_cpu.yml`` (CPU):
  the downstream fit of 8 steps with ``profile_dir`` in the YAML writes
  one trace of steps 2-6 with the tracer's ``train.*`` spans, logs where
  it went and writes ``perf/step_ms`` each epoch; a phase-2 and a
  phase-1 fit of 3 steps each write the trace of their step 2 when they
  end.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from medical_image_segmentation_with_visual_prompts_tpu_torch import (
    config, main)
from medical_image_segmentation_with_visual_prompts_tpu_torch.train.common \
    import StepProfiler
from test_torch_cli import _scalars, _volumes, argv, cli_args
from test_torch_swin_unetr import tiny_conf


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def _trace_names(path: Path) -> set:
    return {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}


def test_profiler_times_steps_and_traces_two_to_six(tmp_path):
    log = _Log()
    prof = StepProfiler(log, tmp_path / "prof", rank=1)
    assert prof.worker.endswith("_rank1")
    x = torch.ones(8, 8)
    for step in range(9):
        prof.step_begin(step)
        with torch.profiler.record_function(f"mark_step_{step}"):
            x = x @ x / 8
        prof.step_end(step)
    prof.close()
    assert len(prof.durations) == 9
    assert prof.mean_ms(last=3) == pytest.approx(
        1e3 * np.mean(prof.durations[-3:]))
    trace, = (tmp_path / "prof").iterdir()
    assert trace == prof.trace_path and trace.name.startswith(prof.worker)
    marks = {n for n in _trace_names(trace) if str(n).startswith("mark_")}
    assert marks == {f"mark_step_{s}" for s in range(2, 7)}
    assert log.lines == [f"Profiler trace written to {trace}."]
    short = StepProfiler(log, tmp_path / "short")
    for step in range(4):
        short.step_begin(step)
        short.step_end(step)
    assert not (tmp_path / "short").exists() or \
        not list((tmp_path / "short").iterdir())
    short.close()
    assert len(list((tmp_path / "short").iterdir())) == 1
    assert StepProfiler(log).mean_ms() == 0.0


def _fit(root: Path, mode: str, volumes: int, **over):
    """``main --mode fit`` of ``mode`` on the CPU with ``profile_dir`` set
    in the YAML; returns the trainer."""
    _volumes(root, "v", [(20 + k % 3, 18, 9) for k in range(volumes)], 4)
    conf = tiny_conf(image_dir_downstream=str(root / "v_img"),
                     mask_dir_downstream=str(root / "v_msk"),
                     image_dir_pretrain=str(root / "v_img"),
                     image_dir_supervised=str(root / "v_img"),
                     mask_dir_supervised=str(root / "v_msk"),
                     profile_dir=str(root / "prof"), **over)
    for key in ("training_mode", "use_encoder_prompting",
                "use_decoder_prompting"):
        conf.pop(key)
    (root / "fit.yml").write_text(yaml.safe_dump(conf))
    args = cli_args(training_mode=mode, configs=str(root / "fit.yml"),
                    run_name=mode,
                    use_decoder_prompting=mode != config.PHASE1_MODE)
    parsed = main.build_parser().parse_args(argv(args))
    hp = config.get_full_configs(parsed)
    assert hp.profile_dir == str(root / "prof")      # the YAML's key
    return main.main(parsed.mode, hp, parsed.device)


@pytest.fixture
def roots(tmp_path, monkeypatch):
    monkeypatch.setattr(config, "DEFAULT_CKPT_DIR", tmp_path / "ckpts")
    monkeypatch.setattr(config, "DEFAULT_ROOT_LOG_DIR", tmp_path / "logs")
    return tmp_path


def test_downstream_fit_writes_one_trace_of_steps_two_to_six(roots):
    # 5 volumes split 0.8: 4 train x 2 crops = 4 steps per epoch, 2 epochs.
    tr = _fit(roots, "downstream", 5, max_epochs_downstream=1)
    assert len(tr.step_ms) == 8
    trace, = (roots / "prof").iterdir()
    assert trace.name.endswith(".pt.trace.json")
    names = _trace_names(trace)
    assert "aten::mm" in names or "aten::addmm" in names
    assert "train.step" in names          # the tracer's spans
    rows = [r for r in _scalars(tr.hparams.summary_dir)
            if r["tag"] == "perf/step_ms"]
    assert [r["step"] for r in rows] == [0, 1]
    assert rows[1]["value"] == pytest.approx(np.mean(tr.step_ms))
    log = (Path(tr.hparams.log_dir) / "log.txt").read_text()
    assert f"Profiler trace written to {trace}." in log


@pytest.mark.parametrize("mode", ["supervised_learning_all",
                                  config.PHASE1_MODE])
def test_pretraining_fits_write_their_trace(roots, mode):
    # 4 volumes split 0.8: 3 train x 2 crops = 3 steps; the trace of step
    # 2 is open when the run ends, and written then.
    tr = _fit(roots, mode, 4)
    assert len(tr.step_ms) == 3
    trace, = (roots / "prof").iterdir()
    assert trace == tr.profiler.trace_path
    tags = {r["tag"] for r in _scalars(tr.hparams.summary_dir)}
    assert "perf/step_ms" in tags
