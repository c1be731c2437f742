"""PyTorch port: entry points run on the CUDA card unless the caller asks
for the CPU, and raise -- never fall back -- when there is no card."""

from argparse import Namespace
from datetime import datetime

import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu_torch import (
    config, infer, main)
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu_torch.parallel import \
    BucketedInference
from medical_image_segmentation_with_visual_prompts_tpu_torch.train import \
    SegmentationTrainer
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import (
    initialization, resolve_device)
from test_torch_swin_unetr import tiny_conf

NO_CUDA = "no CUDA device"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda(no_cuda):
    with pytest.raises(RuntimeError, match=NO_CUDA):
        resolve_device()
    with pytest.raises(RuntimeError, match=NO_CUDA):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_model_needs_cuda_or_an_explicit_cpu(no_cuda):
    conf = tiny_conf()
    with pytest.raises(RuntimeError, match=NO_CUDA):
        infer.build_model(conf)
    model = infer.build_model(conf, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert not model.training


def test_infer_cli_defaults_to_cuda(no_cuda, tmp_path):
    import yaml
    conf = tiny_conf()
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(yaml.safe_dump(conf))
    ckpt = tmp_path / "model.pt"
    torch.save({"model_state_dict": SwinUnetR(
        ModelConfig.from_mapping(conf)).state_dict()}, ckpt)
    with pytest.raises(RuntimeError, match=NO_CUDA):
        infer.main(["--configs", str(cfg), "--ckpt", str(ckpt), "--input",
                    str(tmp_path / "in.nii.gz"), "--output",
                    str(tmp_path / "out.nii.gz")])


def test_bucketed_inference_needs_cuda_or_an_explicit_cpu(no_cuda):
    def fn(b):
        return b
    with pytest.raises(RuntimeError, match=NO_CUDA):
        BucketedInference(fn, (8, 8, 4))
    assert BucketedInference(fn, (8, 8, 4), device="cpu").device.type == "cpu"


def test_trainer_needs_cuda_or_an_explicit_cpu(no_cuda, tmp_path,
                                               monkeypatch):
    hp = Namespace(**tiny_conf())
    with pytest.raises(RuntimeError, match=NO_CUDA):
        SegmentationTrainer(hp, SwinUnetR, None, None)
    tr = SegmentationTrainer(hp, SwinUnetR, None, None, device="cpu")
    assert next(tr.model.parameters()).device.type == "cpu"
    # The save path is the one get_full_configs resolves.
    monkeypatch.setattr(config, "DEFAULT_CKPT_DIR", tmp_path)
    saving = SegmentationTrainer(config.get_full_configs(
        main.build_parser().parse_args([
            "--training-mode", "downstream", "--configs", "tiny_cpu.yml",
            "--save-ckpt-prompt-tokens", "--run-name", "r"]),
        now=datetime(2026, 1, 2, 3, 4, 5)), SwinUnetR, None, None,
        device="cpu")
    assert saving.save_ckpt_path == \
        tmp_path / "prompt_tokens" / "fit_swin_unetr_0102030405_r"
    assert not saving.save_ckpt_path.exists()       # written when saving


def test_main_needs_cuda_or_an_explicit_cpu(no_cuda, tmp_path, monkeypatch):
    monkeypatch.setattr(config, "DEFAULT_ROOT_LOG_DIR", tmp_path)
    args = ["--mode", "test", "--training-mode", "downstream", "--configs",
            "tiny_cpu.yml"]
    with pytest.raises(RuntimeError, match=NO_CUDA):
        main.cli(args)
    hp = config.get_full_configs(main.build_parser().parse_args(args))
    with pytest.raises(RuntimeError, match=NO_CUDA):
        main.main("fit", hp)
    assert not list(tmp_path.iterdir())      # no log directory either
    tr = initialization.select_trainer(
        hp, initialization.select_backbone(hp), None, None, None, None,
        "cpu")
    assert next(tr.model.parameters()).device.type == "cpu"
