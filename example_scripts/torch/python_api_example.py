"""Library-level quickstart of the PyTorch port: train and segment in
Python.

The CLIs (``main`` / ``infer`` of
``medical_image_segmentation_with_visual_prompts_tpu_torch``) wrap these
calls; use this path when embedding the port in a larger pipeline.  It
runs on the CUDA card by default; on the CPU at the tiny config:

    DEVICE=cpu python example_scripts/torch/python_api_example.py
"""

import os
import sys
import tempfile
from argparse import Namespace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    get_full_configs
from medical_image_segmentation_with_visual_prompts_tpu_torch.data import (
    load_served, save_nifti)
from medical_image_segmentation_with_visual_prompts_tpu_torch.infer import (
    load_model, make_runner, predict_device)
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
    .initialization import setup_fitting


def make_conf(tmp: Path):
    """Configs the way the CLI makes them: the argparse namespace merged
    under the YAML file (the YAML wins on duplicate keys)."""
    args = Namespace(
        mode="fit", training_mode="downstream",
        configs="tiny_cpu.yml",
        backbone="swin_unetr", run_name="api_example",
        use_encoder_prompting=True, use_decoder_prompting=True,
        load_ckpt_backbone=False, load_ckpt_backbone_path="",
        save_ckpt_backbone=False, save_ckpt_backbone_path="",
        load_ckpt_prompt_tokens=False, load_ckpt_prompt_tokens_path="",
        save_ckpt_prompt_tokens=False, save_ckpt_prompt_tokens_path="",
    )
    conf = get_full_configs(args)
    # Point the data dirs at synthetic volumes for the example.
    img, msk = tmp / "img", tmp / "msk"
    img.mkdir(), msk.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        save_nifti(str(img / f"case{i}.nii.gz"),
                   rng.normal(0, 400, size=(96, 96, 8)).astype("float32"))
        save_nifti(str(msk / f"case{i}.nii.gz"),
                   (rng.random((96, 96, 8)) > 0.5).astype("int16"))
    for key in ("image_dir_downstream", "image_dir_test"):
        setattr(conf, key, str(img))
    for key in ("mask_dir_downstream", "mask_dir_test"):
        setattr(conf, key, str(msk))
    return conf


def main():
    device = os.environ.get("DEVICE", "cuda")
    tmp = Path(tempfile.mkdtemp())
    conf = make_conf(tmp)

    # --- train: the trainer owns the step, checkpointing and logging
    conf.save_ckpt_prompt_tokens = True
    conf.save_ckpt_prompt_tokens_path = str(tmp / "prompt.ckpt")
    trainer = setup_fitting(conf, device)
    trainer.train()

    # --- serve: load the checkpoint into a fresh model and segment
    model = load_model(vars(conf), tmp / "prompt.ckpt", device)
    runner = make_runner(vars(conf), model, chunk=4)
    volume = load_served(str(tmp / "img" / "case0.nii.gz"), raw=True)
    labels, _ = predict_device(runner, tuple(conf.roi_size), volume)
    labels = labels.cpu().numpy()
    print("label volume:", labels.shape,
          "classes:", sorted(int(v) for v in np.unique(labels)))


if __name__ == "__main__":
    main()
