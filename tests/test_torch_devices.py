"""PyTorch port: entry points run on the CUDA card unless the caller asks
for the CPU, and raise -- never fall back -- when there is no card."""

from argparse import Namespace

import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu_torch import infer
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu_torch.parallel import \
    BucketedInference
from medical_image_segmentation_with_visual_prompts_tpu_torch.train import \
    SegmentationTrainer
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    resolve_device
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


def test_trainer_needs_cuda_or_an_explicit_cpu(no_cuda):
    hp = Namespace(**tiny_conf())
    with pytest.raises(RuntimeError, match=NO_CUDA):
        SegmentationTrainer(hp, SwinUnetR, None, None)
    tr = SegmentationTrainer(hp, SwinUnetR, None, None, device="cpu")
    assert next(tr.model.parameters()).device.type == "cpu"
    with pytest.raises(NotImplementedError, match="prompt checkpoints"):
        SegmentationTrainer(Namespace(**tiny_conf(
            save_ckpt_prompt_tokens=True)), SwinUnetR, None, None,
            device="cpu")
