"""PyTorch port: one cell of ``example_scripts/torch/downstream_example.sh``
(the prompting sweep: fit from a backbone checkpoint, then a test run
whose log is scraped into the result file) at ``tiny_cpu.yml`` with
``DEVICE=cpu``, through the real script and the port's CLI in
subprocesses, as ``tests/test_example_scripts.py`` runs the JAX
package's script."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import yaml

from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.data import \
    save_nifti
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import (
    checkpoint, init_weights)
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
    .torch_import import to_flax_variables

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "example_scripts" / "torch" / "downstream_example.sh"


def test_downstream_sweep_cell_end_to_end(tmp_path):
    img_dir, msk_dir = tmp_path / "img", tmp_path / "msk"
    img_dir.mkdir(), msk_dir.mkdir()
    rng = np.random.default_rng(11)
    for i in range(3):
        save_nifti(img_dir / f"case{i}.nii.gz",
                   rng.normal(0.0, 400.0, (24, 24, 12)).astype(np.float32))
        save_nifti(msk_dir / f"case{i}.nii.gz",
                   (rng.random((24, 24, 12)) > 0.6).astype(np.float32) * 2)
    conf = yaml.safe_load((ROOT / "configurations" / "tiny_cpu.yml")
                          .read_text())
    conf.update(image_dir_downstream=str(img_dir),
                mask_dir_downstream=str(msk_dir), image_dir_test=str(img_dir),
                mask_dir_test=str(msk_dir), max_epochs_downstream=0,
                active_labels_downstream=[0, 1])
    yml = tmp_path / "sweep_tiny.yml"
    yml.write_text(yaml.safe_dump(conf))
    # A backbone checkpoint (the port's msgpack) for the sweep's slot.
    model = SwinUnetR(ModelConfig.from_mapping(
        dict(conf, training_mode="downstream")))
    init_weights(model, torch.Generator().manual_seed(0))
    backbone = tmp_path / "backbone.ckpt"
    checkpoint.save_checkpoint(backbone, 0, to_flax_variables(model))

    ckpt_dir, log_dir = tmp_path / "ckpts", tmp_path / "logs"
    result_file = tmp_path / "result.txt"
    env = dict(os.environ)
    env.update(
        MIVP_CKPT_DIR=str(ckpt_dir), MIVP_LOG_DIR=str(log_dir),
        MIVP_TENSORBOARD="0", PY=sys.executable, DEVICE="cpu",
        CONFIGS=str(yml), BACKBONE_CKPT=str(backbone),
        PROMPT_TOKENS_BASE_DIR=str(ckpt_dir / "prompt_tokens"),
        LOGS_BASE_DIR=str(log_dir), RESULT_FILE=str(result_file),
        CELL_START="8", CELL_END="8",     # the use_ep_use_dp cell
        N_TEST_REPEATS="1",
        CKPT="0001.ckpt",                 # a 1-epoch fit saves 0001
        PYTHONPATH=f"{ROOT}:{env.get('PYTHONPATH', '')}")
    r = subprocess.run(["bash", str(SCRIPT)], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=600)
    # Without a card the port's CLI raises unless --device cpu reached it.
    assert r.returncode == 0, f"sweep cell failed:\n{r.stdout}\n{r.stderr}"
    scraped = result_file.read_text()
    # The per-run report lines the reference grid greps for.
    assert scraped.count(" iou: ") == 1 and scraped.count(" dcc: ") == 1
    assert "+/-" in scraped
