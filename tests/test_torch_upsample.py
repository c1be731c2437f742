"""PyTorch port: the upsample kernel's wrapper (``ops/upsample.py``) on
the CPU, where it runs its plain version, at tiny sizes.

* The wrapper equals the chain the model ran before it, bit for bit, in
  both forms: ``upsample_trilinear`` and the crop to the skip written
  contiguous (plain), and then the head's BatchNorm, cast, conv and
  ``.float()`` as ``SwinUnetR._head`` computes them (head).
* The weights the kernel computes from output indices (``axis_taps``,
  the plain version of ``csrc/upsample.cu::axis_tap``) equal
  ``interp_matrix``'s entries, both conventions.
* A tiny downstream ``SwinUnetR`` eval forward equals the previous code
  path at every up block and at the logits, and launches nothing.
* The wrapper refuses what it cannot compute.

The kernel itself runs on the card only (``tests/test_torch_kernels_cuda
.py -k upsample``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from torch import nn

from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinUnetR
from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
    .unet_blocks import SwinUpBlock, batch_norm, bn_fold, conv3d
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    upsample as up
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
    .conv_fused import conv3x3_fused_pair
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops.resize \
    import interp_matrix, upsample_trilinear
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    init_weights

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread is some 100x faster here than a
    pool, and the worker's setting is put back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _head_modules(c: int, k: int, g: torch.Generator):
    """An eval BatchNorm with drawn statistics and a 3x3x3 conv, as
    ``SwinUnetR`` builds its head."""
    norm = nn.BatchNorm3d(c, eps=1e-5).eval()
    conv = nn.Conv3d(c, k, 3, padding=1)
    with torch.no_grad():
        for t, lo in ((norm.weight, 0.5), (norm.bias, -0.5),
                      (norm.running_mean, -0.5), (norm.running_var, 0.5)):
            t.copy_(lo + torch.rand(t.shape, generator=g))
        conv.weight.copy_(0.2 * torch.randn(conv.weight.shape, generator=g))
        conv.bias.copy_(torch.randn(k, generator=g))
    return norm, conv


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("form", ["crop", "no_crop", "head"])
def test_wrapper_equals_chain_on_cpu(form, dtype):
    g = torch.Generator().manual_seed(1)
    dt = DTYPES[dtype]
    x = torch.randn((2, 3, 4, 2, 8), generator=g).to(dt)
    scale = (2, 2, 2)
    with torch.no_grad():
        if form == "crop":
            got = up.upsample(x, (2, 2, 1), (5, 8, 2))
            want = upsample_trilinear(x, (2, 2, 1))[:, :5, :8, :2] \
                .contiguous()
        elif form == "no_crop":
            got = up.upsample(x, scale)
            want = upsample_trilinear(x, scale)
        else:
            norm, conv = _head_modules(8, 3, g)
            got = up.upsample(x, scale, head=up.Head(
                *bn_fold(norm), conv.weight, conv.bias, dt))
            y = upsample_trilinear(x, scale)
            want = conv3d(batch_norm(y.float(), norm).to(dt), conv).float()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("sizes", [(1, 2), (2, 4), (4, 8), (3, 7), (8, 16),
                                   (2, 2), (5, 5), (7, 3), (64, 128)])
def test_axis_taps_equal_interp_matrix(sizes, align_corners):
    n_in, n_out = sizes
    lo, hi, w_lo, w_hi = up.axis_taps(n_in, n_out, align_corners)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    m[rows, lo] += w_lo
    m[rows, hi] += w_hi
    assert np.array_equal(m, interp_matrix(n_in, n_out, align_corners))
    assert ((lo == hi) <= (w_hi == 0)).all()


def _tiny(dtype: str):
    """tiny_cpu.yml's downstream model, both prompt sets on, and its roi."""
    with open(ROOT / "configurations" / "tiny_cpu.yml") as f:
        conf = yaml.safe_load(f)
    conf.update(training_mode="downstream", use_encoder_prompting=True,
                use_decoder_prompting=True, compute_dtype=dtype)
    model = SwinUnetR(ModelConfig.from_mapping(conf))
    init_weights(model, torch.Generator().manual_seed(3))
    return model.eval(), conf["roi_size"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swin_unetr_eval_equals_previous_path(dtype):
    """Each up block's output and the logits equal the previous eval code
    path on the same inputs: the einsum upsample, the crop's copy, the
    pair conv and the blocks; the einsum upsample and ``_head``."""
    model, roi = _tiny(dtype)
    seen = []

    def record(block, args, out):
        seen.append((block, args, out))

    hooks = [m.register_forward_hook(record) for m in model.decoder_blocks]
    x = torch.rand((1, *roi, 1),
                   generator=torch.Generator().manual_seed(4))
    up.upsample.launches = 0
    with torch.inference_mode():
        logits = model(x)
        for block, (xin, skip, tokens), out in seen:
            assert isinstance(block, SwinUpBlock)
            y = upsample_trilinear(xin, block.strides, align_corners=False)
            y = y[:, :skip.shape[1], :skip.shape[2],
                  :skip.shape[3]].contiguous()
            conv = block.conv_concat.conv
            y = conv3x3_fused_pair(
                y, skip.to(y.dtype).contiguous(), conv.weight, conv.bias,
                *bn_fold(block.norm_concat), out_dtype=block.dtype)
            assert torch.equal(out, block.swin_layer(y, tokens))
        norm, conv = model.extra_heads[model.head_name]
        y = upsample_trilinear(seen[-1][2], (2, 2, 2), align_corners=False)
        y = batch_norm(y.float(), norm).to(model.conf.dtype)
        want = conv3d(y, conv).float()
    for h in hooks:
        h.remove()
    assert len(seen) == model.conf.depth_unet
    assert torch.equal(logits, want)
    assert up.upsample.launches == 0


@pytest.mark.parametrize("case", ["crop_above_size", "head_channels",
                                  "scale_shape"])
def test_wrapper_refuses(case):
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, 2, 2, 2, 8), generator=g)
    norm, conv = _head_modules(8, 2, g)
    scale, shift = bn_fold(norm)
    with pytest.raises(ValueError):
        if case == "crop_above_size":
            up.upsample(x, (2, 2, 2), (5, 4, 4))
        elif case == "head_channels":
            up.upsample(x[..., :4], (2, 2, 2), head=up.Head(
                scale[:4], shift[:4], conv.weight, conv.bias, x.dtype))
        else:
            up.upsample(x, (2, 2, 2), head=up.Head(
                scale[:4], shift, conv.weight, conv.bias, x.dtype))
