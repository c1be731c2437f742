"""PyTorch port: each CUDA kernel against its plain version, on the card.

Imports torch and the port only (the machine with the card has no JAX),
so it runs there without this directory's conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device every test skips.  Tolerance: 4 bf16 ulps of the
largest output (2^-6 relative to it), the bound ``chip_smoke.py``
states: kernel and plain version both use bf16 operands and fp32 sums,
and a sum in another order flips at most a few bf16 roundings.  The
backward kernel's gradients are held to ``GRAD_TOL`` of each gradient's
largest magnitude: it rounds P, dS and the row gradients to bf16 where
the plain version (autograd of ``block_reference``) keeps fp32.
"""

import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    conv_fused as cf
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block as fb
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block_bwd as fbb

TOL = 2.0 ** -6
GRAD_TOL = 2.0 ** -5
DROP = fb.Dropout((2024, 77), 0.1, 0.1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run on the chip only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= TOL * max(1.0, ref.abs().max().item()), err


def _block_case(dev, b, p, m, c, heads, fold_mode, shifted, n_tok, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    params = {"ln1_scale": 1 + 0.1 * r(c), "ln1_bias": 0.2 * r(c),
              "wq": r(c, c) / c ** 0.5, "wk": r(c, c) / c ** 0.5,
              "wv": r(c, c) / c ** 0.5, "wproj": r(c, c) / c ** 0.5,
              "bproj": 0.1 * r(c), "ln2_scale": 1 + 0.1 * r(c),
              "ln2_bias": 0.1 * r(c), "wmlp": r(c, c) / c ** 0.5,
              "bmlp": 0.1 * r(c)}
    params = {k: v.to(dev) for k, v in params.items()}
    tokens = r(n_tok, c).to(dev) if n_tok else None
    n = m + (1 if fold_mode else 0) + n_tok
    bias = r(heads, m, n).to(dev)
    ops = fb.make_operands(params, tokens, bias, fold_mode, heads,
                           (c // heads) ** -0.5)
    labels = None
    if shifted:
        labels = torch.cat([torch.randint(0, 4, (p, m), generator=g),
                            torch.full((p, n - m), -1)], 1)
        labels = labels.to(dev, torch.int32).contiguous()
    x = r(b, p, m, c).to(dev, torch.bfloat16)
    return x, ops, labels


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,m", [
    (16, 2, 32), (32, 2, 48), (48, 4, 64), (96, 8, 100), (96, 4, 128),
    (64, 2, 40), (128, 2, 64), (192, 4, 128), (32, 2, 320)])
@pytest.mark.parametrize("fold_mode,shifted,n_tok", [
    (fb.FOLD_NONE, False, 0), (fb.FOLD_NONE, True, 5),
    (fb.FOLD_KEY, False, 7), (fb.FOLD_COUNT, True, 3)])
def test_fused_swin_block_kernel_matches_plain(dev, c, heads, m, fold_mode,
                                               shifted, n_tok):
    x, ops, labels = _block_case(dev, 2, 3, m, c, heads, fold_mode, shifted,
                                 n_tok)
    with torch.inference_mode():
        ref = fb.block_reference(x, ops, labels)
        before = fb.fused_swin_block.launches
        got = fb.fused_swin_block(x, ops, labels)
        torch.cuda.synchronize()
    assert fb.fused_swin_block.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _assert_close(got, ref)


@pytest.mark.cuda
def test_fused_swin_block_rejects_fp32_and_unsupported_head_dims(dev):
    x, ops, labels = _block_case(dev, 1, 2, 32, 48, 4, fb.FOLD_NONE, True, 2)
    with pytest.raises(ValueError, match="x_win must be bfloat16"):
        fb.fused_swin_block(x.float(), ops, labels)
    x, ops, labels = _block_case(dev, 1, 2, 32, 80, 4, fb.FOLD_NONE, False, 0)
    with pytest.raises(ValueError, match="head dim"):
        fb.fused_swin_block(x, ops, labels)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ca,cb,co", [
    ((2, 6, 5, 4), 32, 16, 16), ((1, 8, 8, 2), 96, 48, 48),
    ((3, 5, 7, 3), 16, 16, 32), ((1, 16, 16, 2), 384, 192, 192)])
def test_conv3x3_pair_kernel_matches_plain(dev, shape, ca, cb, co):
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    xa = r(*shape, ca).to(dev, torch.bfloat16)
    xb = r(*shape, cb).to(dev, torch.bfloat16)
    w = (r(co, ca + cb, 3, 3, 3) / (27 * (ca + cb)) ** 0.5).to(dev)
    bias = (0.1 * r(co)).to(dev)
    scale = (0.5 + torch.rand(ca + cb, generator=g)).to(dev)
    shift = (2.0 + 0.3 * r(ca + cb)).to(dev)    # leaky(shift) != 0
    with torch.inference_mode():
        ref = cf.conv_pair_reference(xa, xb, w, bias, scale, shift)
        before = cf.conv3x3_fused_pair.launches
        got = cf.conv3x3_fused_pair(xa, xb, w, bias, scale, shift)
        torch.cuda.synchronize()
    assert cf.conv3x3_fused_pair.launches == before + 1
    assert got.shape == (*shape, co) and got.dtype == torch.bfloat16
    _assert_close(got, ref)


@pytest.mark.cuda
def test_conv3x3_pair_rejects_unaligned_channels(dev):
    xa = torch.zeros(1, 4, 4, 2, 8, device=dev, dtype=torch.bfloat16)
    xb = torch.zeros(1, 4, 4, 2, 16, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(16, 24, 3, 3, 3, device=dev)
    z = torch.zeros(24, device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        cf.conv3x3_fused_pair(xa, xb, w, torch.zeros(16, device=dev), z, z)


TRAIN_SHAPES = [(16, 2, 32), (48, 4, 64), (96, 8, 100), (96, 4, 128),
                (192, 4, 128), (48, 4, 256)]
TRAIN_CASES = [(fb.FOLD_NONE, False, 0), (fb.FOLD_NONE, True, 5),
               (fb.FOLD_KEY, False, 7), (fb.FOLD_COUNT, True, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,m", TRAIN_SHAPES)
@pytest.mark.parametrize("fold_mode,shifted,n_tok", TRAIN_CASES)
def test_dropout_forward_kernel_matches_plain(dev, c, heads, m, fold_mode,
                                              shifted, n_tok):
    x, ops, labels = _block_case(dev, 2, 3, m, c, heads, fold_mode, shifted,
                                 n_tok, seed=3)
    with torch.inference_mode():
        ref = fb.block_reference(x, ops, labels, DROP)
        got = fb.fused_swin_block(x, ops, labels, DROP)
        torch.cuda.synchronize()
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,m", TRAIN_SHAPES)
@pytest.mark.parametrize("fold_mode,shifted,n_tok", TRAIN_CASES)
def test_block_backward_kernel_matches_plain(dev, c, heads, m, fold_mode,
                                             shifted, n_tok):
    x, ops, labels = _block_case(dev, 2, 3, m, c, heads, fold_mode, shifted,
                                 n_tok, seed=4)
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(9)
                       ).to(dev, torch.bfloat16)
    ref_dx, ref = fbb.block_backward_reference(x, dout, ops, labels, DROP)
    before = fbb.block_backward.launches
    dx, got = fbb.block_backward(x, dout, ops, labels, DROP)
    torch.cuda.synchronize()
    assert fbb.block_backward.launches == before + 1
    names = ["x", "bias", "ext_k", "ext_v", *fb.PARAM_KEYS]
    for name, g, r in zip(names, (dx, *got), (ref_dx, *ref)):
        if r is None:
            assert g is None, name
            continue
        g, r = g.float(), r.float()
        assert torch.isfinite(g).all(), name
        err = (g - r).abs().max().item()
        scale = r.abs().max().item()
        print(f"{name}: err {err:.4g} of max {scale:.4g}")
        assert err <= GRAD_TOL * max(scale, 1e-6), (name, err, scale)
