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
the plain version (autograd of ``block_reference``) keeps fp32; it sums
in a fixed order, so two runs give the same bits.  The
block pair kernel (B5) is also held bit for bit to B1, the pair's row
gather, B1 and the inverse gather: it runs B1's device code twice and
rounds block 1's output to the array dtype where the two launches store
it.  Every kernel but the conv (which rounds fp32 inputs to bf16 in its
wrapper) reads and writes fp32 activations as well as bf16 (an fp32
trunk), with the same tolerances.
"""

import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    conv_fused as cf
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block as fb
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    ConsecutiveSwinBlocks, SwinTransformerBlock
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block_bwd as fbb
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_pair as fp
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    init_weights
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    window_attention as wa

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


def _bias_case(dev, g, heads, m, fold_mode, n_tok):
    """A block bias and its factors: per-axis tables of an 8x8xpd window
    holding the m content rows (all of it, or m positions of it as where
    a geometry is pad-folded), a fold column, prompt-token columns; the
    content in the relative-position module's order of operations."""
    r = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa: E731
    pd = -(-m // 64)
    index = torch.arange(m) if m == 64 * pd else \
        torch.randperm(64 * pd, generator=g)[:m].sort().values
    factors = fb.BiasFactors((r(heads, 8, 8), r(heads, 8, 8),
                              r(heads, pd, pd)), index.to(dev), 64 ** -0.5)
    ih, iw, id_ = factors.coords().to(dev).unbind(-1)
    rt, ct, dt = factors.axes
    cols = [(rt[:, ih[:, None], ih[None, :]] + ct[:, iw[:, None], iw[None, :]]
             + dt[:, id_[:, None], id_[None, :]]) / 3.0 * factors.scale]
    if fold_mode:
        cols.append(r(heads, m, 1))
    if n_tok:
        cols.append(r(heads, 1, n_tok).expand(heads, m, n_tok))
    return torch.cat(cols, -1), factors


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
    bias, factors = _bias_case(dev, g, heads, m, fold_mode, n_tok)
    ops = fb.make_operands(params, tokens, bias, fold_mode, heads,
                           (c // heads) ** -0.5, factors=factors)
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
@pytest.mark.parametrize("c,heads,m", [(48, 4, 64), (96, 8, 100),
                                       (192, 4, 128), (48, 4, 256)])
@pytest.mark.parametrize("fold_mode,shifted,n_tok", [
    (fb.FOLD_NONE, True, 5), (fb.FOLD_KEY, False, 7),
    (fb.FOLD_COUNT, True, 3)])
def test_fused_swin_block_kernel_takes_fp32(dev, c, heads, m, fold_mode,
                                            shifted, n_tok):
    """fp32 x_win (an fp32 trunk): read and written as fp32, LN, softmax
    and residuals in fp32, only the matmul operands rounded to bf16."""
    x, ops, labels = _block_case(dev, 2, 3, m, c, heads, fold_mode, shifted,
                                 n_tok, seed=11)
    x = x.float() + 1e-3 * torch.randn(x.shape, device=dev)  # not bf16
    with torch.inference_mode():
        ref = fb.block_reference(x, ops, labels)
        got = fb.fused_swin_block(x, ops, labels)
        got_drop = fb.fused_swin_block(x, ops, labels, DROP)
        ref_drop = fb.block_reference(x, ops, labels, DROP)
        torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == x.shape
    _assert_close(got, ref)
    _assert_close(got_drop, ref_drop)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(192, 4), (192, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_swin_block_spills_large_windows(dev, c, heads, dtype):
    """M 256 at C 192 (the reference padding's 16x16x2 stages) exceeds one
    CTA's shared memory: the window is split over a cluster of CTAs
    whatever the batch (3 windows here), with the same arithmetic."""
    x, ops, labels = _block_case(dev, 1, 3, 256, c, heads, fb.FOLD_NONE,
                                 True, 5, seed=14)
    x = x.to(dtype)
    info = fb.launch_info(x, ops, labels)
    assert info["cluster"] > 1 and info["smem"] <= 227 * 1024, info
    with torch.inference_mode():
        ref = fb.block_reference(x, ops, labels)
        got = fb.fused_swin_block(x, ops, labels)
        got_drop = fb.fused_swin_block(x, ops, labels, DROP)
        ref_drop = fb.block_reference(x, ops, labels, DROP)
        torch.cuda.synchronize()
    assert got.dtype == dtype
    _assert_close(got, ref)
    _assert_close(got_drop, ref_drop)


@pytest.mark.cuda
def test_fused_swin_block_rejects_fp32_and_unsupported_head_dims(dev):
    """fp32 and bf16 are the activation dtypes; anything else raises."""
    x, ops, labels = _block_case(dev, 1, 2, 32, 48, 4, fb.FOLD_NONE, True, 2)
    with pytest.raises(ValueError, match="x_win must be float32 or bfloat16"):
        fb.fused_swin_block(x.half(), ops, labels)
    x, ops, labels = _block_case(dev, 1, 2, 32, 80, 4, fb.FOLD_NONE, False, 0)
    with pytest.raises(ValueError, match="head dim"):
        fb.fused_swin_block(x, ops, labels)


# The flagship's six block geometries (C, heads, dims; window 8x8x4, 64
# prompt tokens): 64x64x4 padded-free (M 256, N 320), 32x32x2 and 16x16x2
# pad-folded (M 128, N 193).
FLAGSHIP_BLOCKS = [(48, 4, (64, 64, 4)), (96, 8, (32, 32, 2)),
                   (192, 16, (16, 16, 2)), (192, 4, (16, 16, 2)),
                   (96, 4, (32, 32, 2)), (48, 4, (64, 64, 4))]


def _flagship_block(dev, c, heads, dims, shift, batch, dtype, seed=15):
    """A flagship Swin block's windows, operands (bias factors from its
    relative-position module) and labels at ``batch`` images."""
    g = torch.Generator().manual_seed(seed)
    blk = SwinTransformerBlock(c, (8, 8, 4), 64, heads, 1, 64,
                               shift_size=shift, pad_mode="aligned",
                               dtype=torch.bfloat16)
    blk = init_weights(blk, g).to(dev)
    x = torch.randn((batch, *dims, c), generator=g).to(dev, dtype)
    tok = (0.5 * torch.randn((64, c), generator=g)).to(dev)
    with torch.no_grad():
        x_win, ops, labels, _ = blk.windows(x, tok)
    return x_win, ops, labels


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims", FLAGSHIP_BLOCKS)
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dropout", [False, True])
def test_fused_swin_block_flagship_geometries(dev, c, heads, dims, shift,
                                              dtype, dropout):
    """B1 on the flagship's blocks at batch 2 (the training batch: 2-8
    CTAs per window), bias built in the kernel from the module's
    factors."""
    x, ops, labels = _flagship_block(dev, c, heads, dims, shift, 2, dtype)
    drop = DROP if dropout else fb.NO_DROPOUT
    with torch.inference_mode():
        ref = fb.block_reference(x, ops, labels, drop)
        got = fb.fused_swin_block(x, ops, labels, drop)
        torch.cuda.synchronize()
    assert got.dtype == dtype
    _assert_close(got, ref)


# The Swin output layer of the full/simple + swin layouts: a SwinUpBlock
# at the input resolution, C 48, 4 heads, 128x128x8 (M 256, N 320; 512
# windows per image, eight times enc0's 64).
OUTPUT_LAYER_BLOCK = (48, 4, (128, 128, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dropout", [False, True])
def test_fused_swin_block_output_layer(dev, shift, dtype, dropout):
    """B1 on the output layer's blocks at batch 2 (1024 windows; the
    dropout counters of 1024 windows stay within 32 bits)."""
    x, ops, labels = _flagship_block(dev, *OUTPUT_LAYER_BLOCK, shift, 2,
                                     dtype)
    assert x.shape[:2] == (2, 512)
    drop = DROP if dropout else fb.NO_DROPOUT
    with torch.inference_mode():
        ref = fb.block_reference(x, ops, labels, drop)
        got = fb.fused_swin_block(x, ops, labels, drop)
        torch.cuda.synchronize()
    assert got.dtype == dtype
    _assert_close(got, ref)


# (C, heads, dims, images, the cluster size B1 picks for that many
# windows, images of a second batch that picks another size)
CLUSTER_CASES = [(48, 4, (64, 64, 4), 27, 1, 1),
                 (96, 8, (32, 32, 2), 27, 2, 1),
                 (48, 4, (64, 64, 4), 2, 4, 40),
                 (192, 16, (16, 16, 2), 2, 8, 40),
                 (192, 4, (16, 16, 2), 27, 2, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims,batch,ks,other_batch", CLUSTER_CASES)
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
@pytest.mark.parametrize("dropout", [False, True])
def test_fused_swin_block_each_cluster_size(dev, c, heads, dims, batch, ks,
                                            other_batch, shift, dropout):
    """B1 at each cluster size it picks, against its plain version, and
    bit for bit the same output (dropout masks included) when the same
    windows lead a batch that picks another cluster size."""
    x, ops, labels = _flagship_block(dev, c, heads, dims, shift, batch,
                                     torch.bfloat16)
    drop = DROP if dropout else fb.NO_DROPOUT
    assert fb.launch_info(x, ops, labels, drop)["cluster"] == ks
    other = x[:other_batch].contiguous() if other_batch < batch else \
        torch.cat([x, x[:1].expand(other_batch - batch, *x.shape[1:])])
    assert fb.launch_info(other, ops, labels, drop)["cluster"] != ks
    with torch.inference_mode():
        ref = fb.block_reference(x, ops, labels, drop)
        before = fb.fused_swin_block.launches
        got = fb.fused_swin_block(x, ops, labels, drop)
        got_other = fb.fused_swin_block(other, ops, labels, drop)
        torch.cuda.synchronize()
    assert fb.fused_swin_block.launches == before + 2
    _assert_close(got, ref)
    n = min(len(x), len(other))
    assert torch.equal(got[:n], got_other[:n]), \
        int((got[:n] != got_other[:n]).sum())


# (shape, Ca, Cb, Co): the flagship's three decoder convs at batch 2,
# then awkward ones: H and W not multiples of the brick, depths 1, 3, 5
# and 6 (a depth of bricks, a partly used brick), a voxel count that is no
# multiple of the tile.
CONV_CASES = [((2, 64, 64, 4), 96, 48, 48), ((2, 32, 32, 2), 192, 96, 96),
              ((2, 16, 16, 2), 384, 192, 192), ((1, 13, 11, 4), 32, 16, 16),
              ((3, 9, 17, 3), 16, 32, 32), ((1, 20, 7, 5), 48, 16, 64),
              ((2, 5, 9, 1), 16, 16, 48), ((1, 7, 6, 6), 32, 32, 16),
              ((2, 6, 5, 4), 32, 16, 16), ((1, 8, 8, 2), 96, 48, 48),
              ((3, 5, 7, 3), 16, 16, 32), ((1, 16, 16, 2), 384, 192, 192)]


def _conv_case(dev, shape, ca, cb, co, seed=1, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    xa = r(*shape, ca).to(dev, dtype)
    xb = r(*shape, cb).to(dev, dtype) if cb else None
    cin = ca + cb
    w = (r(co, cin, 3, 3, 3) / (27 * cin) ** 0.5).to(dev)
    bias = (0.1 * r(co)).to(dev)
    scale = (0.5 + torch.rand(cin, generator=g)).to(dev)
    # A large shift: leaky(shift) != 0, so padding before the prologue
    # would move every border voxel.
    shift = (3.0 + 0.3 * r(cin)).to(dev)
    return xa, xb, w, bias, scale, shift


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ca,cb,co", CONV_CASES)
def test_conv3x3_pair_kernel_matches_plain(dev, shape, ca, cb, co):
    xa, xb, w, bias, scale, shift = _conv_case(dev, shape, ca, cb, co)
    with torch.inference_mode():
        ref = cf.conv_pair_reference(xa, xb, w, bias, scale, shift)
        before = cf.conv3x3_fused_pair.launches
        got = cf.conv3x3_fused_pair(xa, xb, w, bias, scale, shift)
        torch.cuda.synchronize()
    assert cf.conv3x3_fused_pair.launches == before + 1
    assert got.shape == (*shape, co) and got.dtype == torch.bfloat16
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ca,cb,co", [CONV_CASES[0], CONV_CASES[3],
                                            CONV_CASES[5]])
def test_conv3x3_pair_kernel_writes_fp32(dev, shape, ca, cb, co):
    """fp32 inputs (an fp32 trunk) are rounded to bf16 as the JAX wrapper
    rounds them; the output is fp32."""
    xa, xb, w, bias, scale, shift = _conv_case(dev, shape, ca, cb, co,
                                               seed=3, dtype=torch.float32)
    with torch.inference_mode():
        ref = cf.conv_pair_reference(xa, xb, w, bias, scale, shift,
                                     out_dtype=torch.float32)
        got = cf.conv3x3_fused_pair(xa, xb, w, bias, scale, shift)
        torch.cuda.synchronize()
    assert got.dtype == torch.float32
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32)])
def test_conv3x3_pair_kernel_output_layer(dev, dtype, out_dtype):
    """The Swin output layer's conv: 48 + 48 -> 48 at 128x128x8 (depth 8,
    3.5 M output voxels per 27 windows), batch 2; written in the block's
    dtype (``out_dtype``) whatever the inputs' (an fp32 trunk after a
    ``full`` bottleneck, a bf16 block)."""
    xa, xb, w, bias, scale, shift = _conv_case(dev, (2, 128, 128, 8), 48,
                                               48, 48, seed=4, dtype=dtype)
    with torch.inference_mode():
        ref = cf.conv_pair_reference(xa, xb, w, bias, scale, shift,
                                     out_dtype=out_dtype)
        got = cf.conv3x3_fused_pair(xa, xb, w, bias, scale, shift,
                                    out_dtype=out_dtype)
        torch.cuda.synchronize()
    assert got.shape == (2, 128, 128, 8, 48) and got.dtype == out_dtype
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_warp", [32, 64])
@pytest.mark.parametrize("bn", [16, 32, 48])
@pytest.mark.parametrize("shape", [(2, 16, 16, 2), (1, 13, 11, 4),
                                   (1, 9, 9, 3)])
def test_conv3x3_kernel_every_tile(dev, rows_per_warp, bn, shape):
    """Each tile instantiation of the kernel on the same inputs."""
    xa, xb, w, bias, scale, shift = _conv_case(dev, shape, 32, 64, 96)
    with torch.inference_mode():
        ref = cf.conv_pair_reference(xa, xb, w, bias, scale, shift)
        got = cf._launch(xa, xb, cf.kernel_weight(w), bias, scale, shift,
                         True, "conv3x3", torch.bfloat16,
                         (rows_per_warp, bn))
        info = cf.tile_info(shape[:4], 96, (rows_per_warp, bn))
        torch.cuda.synchronize()
    assert info["rows_per_warp"] == rows_per_warp and info["bn"] == bn
    assert info["ctas_per_sm"] >= 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,m", [(48, 4, 64), (96, 4, 128),
                                       (192, 4, 128), (48, 4, 256)])
@pytest.mark.parametrize("fold_mode,shifted,n_tok", TRAIN_CASES[1:])
def test_block_backward_kernel_takes_fp32(dev, c, heads, m, fold_mode,
                                          shifted, n_tok):
    """fp32 x_win and dout: dx in fp32; the residual gradients read dout
    unrounded, the matmul operands are bf16."""
    x, ops, labels = _block_case(dev, 2, 3, m, c, heads, fold_mode, shifted,
                                 n_tok, seed=13)
    x = x.float() + 1e-3 * torch.randn(x.shape, device=dev)
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        10)).to(dev)
    ref_dx, ref = fbb.block_backward_reference(x, dout, ops, labels, DROP)
    dx, got = fbb.block_backward(x, dout, ops, labels, DROP)
    torch.cuda.synchronize()
    assert dx.dtype == torch.float32
    names = ["x", "bias", "ext_k", "ext_v", *fb.PARAM_KEYS]
    for name, g, r in zip(names, (dx, *got), (ref_dx, *ref)):
        if r is None:
            assert g is None, name
            continue
        g, r = g.float(), r.float()
        assert torch.isfinite(g).all(), name
        err = (g - r).abs().max().item()
        scale = r.abs().max().item()
        assert err <= GRAD_TOL * max(scale, 1e-6), (name, err, scale)


GRAD_NAMES = ["x", "bias", "ext_k", "ext_v", *fb.PARAM_KEYS]
# The gradients B4 sums per window in one order whatever the cluster
# size; the others (dWproj, dWmlp and the vectors) are sums of per-CTA
# partials over each CTA's rows, so another cluster size rounds them
# differently (fp32, relative ~1e-6).
PER_WINDOW_GRADS = ("x", "bias", "ext_k", "ext_v", "wq", "wk", "wv")


def _flat_grads(dx, grads):
    return dict(zip(GRAD_NAMES, (dx, *grads)))


def _assert_grads_close(got, ref):
    for name in GRAD_NAMES:
        g, r = got[name], ref[name]
        if r is None:
            assert g is None, name
            continue
        g, r = g.float(), r.float()
        assert torch.isfinite(g).all(), name
        err = (g - r).abs().max().item()
        scale = r.abs().max().item()
        assert err <= GRAD_TOL * max(scale, 1e-6), (name, err, scale)


# B4 at the flagship training calls (batch 2): 64x64x4 (M 256, N 320),
# enc2 (16 heads) and dec0 (head dim 48), both pad-folded (M 128, N 193).
B4_FLAGSHIP = [(48, 4, (64, 64, 4)), (192, 16, (16, 16, 2)),
               (192, 4, (16, 16, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims", B4_FLAGSHIP)
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dropout", [False, True])
def test_block_backward_flagship_geometries(dev, c, heads, dims, shift,
                                            dtype, dropout):
    """B4 on the flagship's training calls against the autograd of the
    plain block, each gradient within GRAD_TOL of its largest
    magnitude; 8-window calls run on 64 CTAs or more."""
    x, ops, labels = _flagship_block(dev, c, heads, dims, shift, 2, dtype)
    drop = DROP if dropout else fb.NO_DROPOUT
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        11)).to(dev, dtype)
    ref = _flat_grads(*fbb.block_backward_reference(x, dout, ops, labels,
                                                    drop))
    dx, grads = fbb.block_backward(x, dout, ops, labels, drop)
    torch.cuda.synchronize()
    assert dx.dtype == dtype
    _assert_grads_close(_flat_grads(dx, grads), ref)
    info = fbb.launch_info(x, ops, labels, drop)
    assert info["ctas"] >= 64 and info["smem"] <= 227 * 1024, info


# The phase-2 students' stages that pad H/W and depth materially (crops
# 96x96x8 and 80x80x8 at window 8x8x4, pad_mode aligned: M 256, N 320):
# 20x20x2 at C 96 (encoder, 8 heads; decoder, 4), 10x10x2 and 12x12x2
# at C 192 (encoder, 16 heads; decoder, 4).
STUDENT_BLOCKS = [(96, 8, (20, 20, 2)), (96, 4, (20, 20, 2)),
                  (192, 16, (10, 10, 2)), (192, 4, (12, 12, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims", STUDENT_BLOCKS)
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
@pytest.mark.parametrize("dropout", [False, True])
def test_fused_swin_block_student_geometries(dev, c, heads, dims, shift,
                                             dropout):
    """B1 on the students' materially padded blocks at batch 2, against
    its plain version (the shifted calls with their label mask)."""
    x, ops, labels = _flagship_block(dev, c, heads, dims, shift, 2,
                                     torch.bfloat16)
    assert x.shape[2] == 256 and (labels is not None) == any(shift)
    drop = DROP if dropout else fb.NO_DROPOUT
    with torch.inference_mode():
        ref = fb.block_reference(x, ops, labels, drop)
        got = fb.fused_swin_block(x, ops, labels, drop)
        torch.cuda.synchronize()
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims", STUDENT_BLOCKS)
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
def test_block_backward_student_geometries(dev, c, heads, dims, shift):
    """B4 on the students' materially padded training calls (dropout
    on), each gradient within GRAD_TOL of its largest magnitude."""
    x, ops, labels = _flagship_block(dev, c, heads, dims, shift, 2,
                                     torch.bfloat16)
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        12)).to(dev, torch.bfloat16)
    ref = _flat_grads(*fbb.block_backward_reference(x, dout, ops, labels,
                                                    DROP))
    dx, grads = fbb.block_backward(x, dout, ops, labels, DROP)
    torch.cuda.synchronize()
    _assert_grads_close(_flat_grads(dx, grads), ref)


# The phase-1 encoder's stages (roi 128x128x8, window 8x8x4, 64 prompt
# tokens) at batch 14 (2 volumes x 7 crops).  ``pad_mode: aligned`` (the
# flagship) pad-folds the depth-2 stages (M 128, N 193): 64, 16 and 4
# windows per image at C 48, 96 and 192.  ``reference`` (the example
# config) pads every axis of those stages (40x40x4, 24x24x4: 25 and 9
# windows, M 256, N 320), where B4 takes its device-memory form at C 192.
PHASE1_BLOCKS = [(48, 4, (64, 64, 4)), (96, 8, (32, 32, 2)),
                 (192, 16, (16, 16, 2))]
PHASE1_MODES = [("aligned", torch.bfloat16), ("reference", torch.float32)]
PHASE1_WINDOWS = {"aligned": {48: 64, 96: 16, 192: 4},
                  "reference": {48: 64, 96: 25, 192: 9}}


def _phase1_block(dev, c, heads, dims, shift, pad_mode, dtype, seed=17):
    g = torch.Generator().manual_seed(seed)
    blk = SwinTransformerBlock(c, (8, 8, 4), 64, heads, 1, 64,
                               shift_size=shift, pad_mode=pad_mode,
                               dtype=torch.bfloat16)
    blk = init_weights(blk, g).to(dev)
    x = torch.randn((14, *dims, c), generator=g).to(dev, dtype)
    tok = (0.5 * torch.randn((64, c), generator=g)).to(dev)
    with torch.no_grad():
        x_win, ops, labels, _ = blk.windows(x, tok)
    return x_win, ops, labels


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims", PHASE1_BLOCKS)
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
@pytest.mark.parametrize("pad_mode,dtype", PHASE1_MODES)
def test_fused_swin_block_phase1_geometries(dev, c, heads, dims, shift,
                                            pad_mode, dtype):
    """B1 with dropout at the phase-1 step's block calls (batch 14)."""
    x, ops, labels = _phase1_block(dev, c, heads, dims, shift, pad_mode,
                                   dtype)
    assert x.shape[0] * x.shape[1] == 14 * PHASE1_WINDOWS[pad_mode][c]
    with torch.inference_mode():
        ref = fb.block_reference(x, ops, labels, DROP)
        got = fb.fused_swin_block(x, ops, labels, DROP)
        torch.cuda.synchronize()
    assert got.dtype == dtype
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims", PHASE1_BLOCKS)
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
@pytest.mark.parametrize("pad_mode,dtype", PHASE1_MODES)
def test_block_backward_phase1_geometries(dev, c, heads, dims, shift,
                                          pad_mode, dtype):
    """B4 with dropout at the phase-1 step's training calls (batch 14):
    each gradient within GRAD_TOL of its largest magnitude, two runs
    with the same bits; the reference padding's C 192 calls (M 256) in
    the device-memory form."""
    x, ops, labels = _phase1_block(dev, c, heads, dims, shift, pad_mode,
                                   dtype)
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        18)).to(dev, dtype)
    ref = _flat_grads(*fbb.block_backward_reference(x, dout, ops, labels,
                                                    DROP))
    got = _flat_grads(*fbb.block_backward(x, dout, ops, labels, DROP))
    again = _flat_grads(*fbb.block_backward(x, dout, ops, labels, DROP))
    torch.cuda.synchronize()
    _assert_grads_close(got, ref)
    for name in GRAD_NAMES:
        if got[name] is not None:
            assert torch.equal(got[name], again[name]), name
    info = fbb.launch_info(x, ops, labels, DROP)
    assert info["big"] == (c == 192 and pad_mode == "reference"), info


# The students' decoder pair convs that no serving path gives B2:
# 10x10x2, 12x12x2, 20x20x2 and 40x40x4 grids at batch 2.
STUDENT_CONVS = [((2, 10, 10, 2), 384, 192, 192),
                 ((2, 12, 12, 2), 384, 192, 192),
                 ((2, 20, 20, 2), 192, 96, 96), ((2, 40, 40, 4), 96, 48, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ca,cb,co", STUDENT_CONVS)
def test_conv3x3_pair_kernel_student_grids(dev, shape, ca, cb, co):
    xa, xb, w, bias, scale, shift = _conv_case(dev, shape, ca, cb, co)
    with torch.inference_mode():
        ref = cf.conv_pair_reference(xa, xb, w, bias, scale, shift)
        got = cf.conv3x3_fused_pair(xa, xb, w, bias, scale, shift)
        torch.cuda.synchronize()
    assert got.shape == (*shape, co)
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dropout", [False, True])
def test_block_backward_output_layer(dev, shift, dtype, dropout):
    """B4 on the output layer's training calls (1024 windows at batch 2)
    against the autograd of the plain block: the shared-memory form at
    enc0's plan (``backward_plan``, held on the CPU in
    ``test_torch_block_bwd_plan.py``)."""
    x, ops, labels = _flagship_block(dev, *OUTPUT_LAYER_BLOCK, shift, 2,
                                     dtype)
    drop = DROP if dropout else fb.NO_DROPOUT
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        12)).to(dev, dtype)
    ref = _flat_grads(*fbb.block_backward_reference(x, dout, ops, labels,
                                                    drop))
    dx, grads = fbb.block_backward(x, dout, ops, labels, drop)
    torch.cuda.synchronize()
    assert dx.dtype == dtype
    _assert_grads_close(_flat_grads(dx, grads), ref)
    info = fbb.launch_info(x, ops, labels, drop)
    assert not info["big"] and info["ctas"] == 2048, info


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [16, 4])
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_backward_device_memory_form(dev, heads, shift, dtype):
    """The example config's training calls at 16x16x2 under the reference
    padding (M 256, N 320 at C 192) fit no shared-memory layout: B4 takes
    its device-memory form (y and dqkv in the workspace), within GRAD_TOL
    of the plain version with dropout, and two runs give the same bits."""
    g = torch.Generator().manual_seed(16)
    blk = SwinTransformerBlock(192, (8, 8, 4), 64, heads, 1, 64,
                               shift_size=shift, pad_mode="reference",
                               dtype=torch.bfloat16)
    blk = init_weights(blk, g).to(dev)
    x = torch.randn((2, 16, 16, 2, 192), generator=g).to(dev, dtype)
    tok = (0.5 * torch.randn((64, 192), generator=g)).to(dev)
    with torch.no_grad():
        x_win, ops, labels, _ = blk.windows(x, tok)
    b, pw, m, _ = x_win.shape
    assert (m, m + ops.n_ext) == (256, 320)
    plan = fbb.backward_plan(b * pw, m, m + ops.n_ext, 192, heads,
                             ops.kernel["pe_tab"].shape[1])
    assert plan.big, plan
    info = fbb.launch_info(x_win, ops, labels, DROP)
    assert (info["cluster"], info["smem"], info["big"]) == \
        (plan.ks, plan.smem, True), info
    dout = torch.randn(x_win.shape, generator=g).to(dev, dtype)
    ref = _flat_grads(*fbb.block_backward_reference(x_win, dout, ops,
                                                    labels, DROP))
    big = fbb.block_backward.big_launches
    got = _flat_grads(*fbb.block_backward(x_win, dout, ops, labels, DROP))
    again = _flat_grads(*fbb.block_backward(x_win, dout, ops, labels, DROP))
    torch.cuda.synchronize()
    assert fbb.block_backward.big_launches == big + 2
    _assert_grads_close(got, ref)
    for name in GRAD_NAMES:
        if got[name] is not None:
            assert torch.equal(got[name], again[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims", FLAGSHIP_BLOCKS[:5])
def test_block_backward_launch_plan(dev, c, heads, dims):
    """launch_info reports the plan backward_plan computes from the
    shapes, and the kernel's shared-memory layout is the one
    backward_smem mirrors."""
    x, ops, labels = _flagship_block(dev, c, heads, dims, (4, 4, 2), 2,
                                     torch.bfloat16)
    b, pw, m, _ = x.shape
    plan = fbb.backward_plan(
        b * pw, m, m + ops.n_ext, c, heads, ops.kernel["pe_tab"].shape[1],
        torch.cuda.get_device_properties(dev).multi_processor_count)
    info = fbb.launch_info(x, ops, labels, DROP)
    assert (info["cluster"], info["ctas"], info["threads"], info["smem"],
            info["big"]) == (plan.ks, b * pw * plan.ks, plan.threads,
                             plan.smem, False), info
    assert info["ctas_per_sm"] >= 1, info


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims", FLAGSHIP_BLOCKS[:5])
def test_block_backward_forced_device_memory_form(dev, c, heads, dims):
    """The device-memory form forced where the shared-memory one fits:
    within GRAD_TOL of the plain version, and counted as that form."""
    x, ops, labels = _flagship_block(dev, c, heads, dims, (4, 4, 2), 2,
                                     torch.bfloat16)
    assert fbb.launch_info(x, ops, labels, DROP, big=True)["big"]
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        17)).to(dev, x.dtype)
    ref = _flat_grads(*fbb.block_backward_reference(x, dout, ops, labels,
                                                    DROP))
    big = fbb.block_backward.big_launches
    got = _flat_grads(*fbb.block_backward(x, dout, ops, labels, DROP,
                                          big=True))
    torch.cuda.synchronize()
    assert fbb.block_backward.big_launches == big + 1
    _assert_grads_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims", B4_FLAGSHIP)
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
@pytest.mark.parametrize("threads", [256, 512])
def test_block_backward_each_cluster_size(dev, c, heads, dims, shift,
                                          threads):
    """B4 at every cluster size that fits, forced, at one thread count
    (the two counts are two compiled instances): each within GRAD_TOL of
    the plain version; the gradients summed per window bit for bit the
    same at every size, the per-CTA sums within fp32 rounding of each
    other."""
    x, ops, labels = _flagship_block(dev, c, heads, dims, shift, 2,
                                     torch.bfloat16)
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        12)).to(dev, torch.bfloat16)
    ref = _flat_grads(*fbb.block_backward_reference(x, dout, ops, labels,
                                                    DROP))
    b, pw, m, _ = x.shape
    base, sizes = None, []
    for ks in (1, 2, 4, 8):
        try:
            fbb.backward_plan(b * pw, m, m + ops.n_ext, c, heads,
                              ops.kernel["pe_tab"].shape[1], cluster=ks)
        except ValueError:
            continue
        sizes.append(ks)
        info = fbb.launch_info(x, ops, labels, DROP, cluster=ks,
                               threads=threads)
        assert (info["cluster"], info["threads"]) == (ks, threads), info
        got = _flat_grads(*fbb.block_backward(x, dout, ops, labels, DROP,
                                              cluster=ks, threads=threads))
        torch.cuda.synchronize()
        _assert_grads_close(got, ref)
        if base is None:
            base = got
            continue
        for name in GRAD_NAMES:
            if base[name] is None:
                continue
            if name in PER_WINDOW_GRADS:
                assert torch.equal(got[name], base[name]), (ks, name)
            else:
                err = (got[name] - base[name]).abs().max().item()
                assert err <= 1e-5 * base[name].abs().max().item(), \
                    (ks, name, err)
    assert len(sizes) >= 2, sizes


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims", B4_FLAGSHIP)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_backward_is_deterministic(dev, c, heads, dims, dtype):
    """Two runs on the same inputs give the same bits in every output:
    no atomics, every sum in a fixed order."""
    x, ops, labels = _flagship_block(dev, c, heads, dims, (4, 4, 2), 2,
                                     dtype)
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        13)).to(dev, dtype)
    first = _flat_grads(*fbb.block_backward(x, dout, ops, labels, DROP))
    second = _flat_grads(*fbb.block_backward(x, dout, ops, labels, DROP))
    torch.cuda.synchronize()
    for name in GRAD_NAMES:
        if first[name] is not None:
            assert torch.equal(first[name], second[name]), name


def _attn_case(dev, b, p, m, n, c, heads, masked, seed=5):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    bias = r(heads, m, n).to(dev)
    labels = None
    if masked:
        labels = torch.cat([torch.randint(0, 4, (p, m), generator=g),
                            torch.full((p, n - m), -1)], 1)
        labels = labels.to(dev, torch.int32).contiguous()
    return r, bias, labels


ATTN_SHAPES = [(48, 4, 256, 320), (96, 8, 256, 320), (96, 4, 256, 320),
               (32, 2, 40, 45), (16, 2, 32, 35), (64, 1, 20, 24),
               (128, 2, 300, 310)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,m,n", ATTN_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_packed_qkv_kernel_matches_plain(dev, c, heads, m, n, masked):
    r, bias, labels = _attn_case(dev, 2, 3, m, n, c, heads, masked)
    y = r(2, 3, n, c).to(dev, torch.bfloat16)
    ws = [(r(c, c) / c ** 0.5).to(dev) for _ in range(3)]
    scale = (c // heads) ** -0.5
    with torch.inference_mode():
        ref = wa.fused_window_attention_packed_qkv_reference(
            y, *ws, m, bias, labels, scale, heads)
        before = wa.fused_window_attention_packed_qkv.launches
        got = wa.fused_window_attention_packed_qkv(y, *ws, m, bias, labels,
                                                   scale, heads)
        torch.cuda.synchronize()
    assert wa.fused_window_attention_packed_qkv.launches == before + 1
    assert got.shape == (2, 3, m, c) and got.dtype == torch.bfloat16
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,m,n", ATTN_SHAPES + [
    (192, 16, 256, 320), (192, 4, 256, 320), (40, 5, 17, 23)])
@pytest.mark.parametrize("masked", [False, True])
def test_packed_and_per_head_kernels_match_plain(dev, c, heads, m, n,
                                                 masked):
    r, bias, labels = _attn_case(dev, 2, 3, m, n, c, heads, masked, seed=6)
    q = r(2, 3, m, c).to(dev, torch.bfloat16)
    k = r(2, 3, n, c).to(dev, torch.bfloat16)
    v = r(2, 3, n, c).to(dev, torch.bfloat16)
    scale = (c // heads) ** -0.5
    dh = c // heads
    with torch.inference_mode():
        ref = wa.fused_window_attention_packed_reference(
            q, k, v, bias, labels, scale, heads)
        before = (wa.fused_window_attention_packed.launches,
                  wa.fused_window_attention.launches)
        got7 = wa.fused_window_attention_packed(q, k, v, bias, labels, scale,
                                                heads)
        got8 = wa.fused_window_attention(
            q.view(2, 3, m, heads, dh), k.view(2, 3, n, heads, dh),
            v.view(2, 3, n, heads, dh), bias, labels, scale)
        torch.cuda.synchronize()
    assert (wa.fused_window_attention_packed.launches,
            wa.fused_window_attention.launches) == (before[0] + 1,
                                                     before[1] + 1)
    _assert_close(got7, ref)
    _assert_close(got8.reshape(2, 3, m, c), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,m,n", [(48, 4, 256, 320), (96, 8, 256, 320),
                                         (32, 2, 40, 45)])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_kernels_take_fp32(dev, c, heads, m, n, masked):
    """fp32 y / q / k / v: rounded to bf16 where the JAX kernels round
    them (q after its fp32 scale); the output is fp32."""
    r, bias, labels = _attn_case(dev, 2, 3, m, n, c, heads, masked, seed=8)
    y = r(2, 3, n, c).to(dev)
    q = r(2, 3, m, c).to(dev)
    k = r(2, 3, n, c).to(dev)
    v = r(2, 3, n, c).to(dev)
    ws = [(r(c, c) / c ** 0.5).to(dev) for _ in range(3)]
    scale = (c // heads) ** -0.5
    dh = c // heads
    with torch.inference_mode():
        ref6 = wa.fused_window_attention_packed_qkv_reference(
            y, *ws, m, bias, labels, scale, heads)
        got6 = wa.fused_window_attention_packed_qkv(y, *ws, m, bias, labels,
                                                    scale, heads)
        ref7 = wa.fused_window_attention_packed_reference(
            q, k, v, bias, labels, scale, heads)
        got8 = wa.fused_window_attention(
            q.view(2, 3, m, heads, dh), k.view(2, 3, n, heads, dh),
            v.view(2, 3, n, heads, dh), bias, labels, scale)
        torch.cuda.synchronize()
    assert got6.dtype == got8.dtype == torch.float32
    _assert_close(got6, ref6)
    _assert_close(got8.reshape(2, 3, m, c), ref7)


@pytest.mark.cuda
def test_window_attention_rejects_fp32_and_unsupported_head_dims(dev):
    """fp32 and bf16 are the activation dtypes; anything else raises."""
    r, bias, _ = _attn_case(dev, 1, 2, 16, 20, 80, 4, False)
    q = r(1, 2, 16, 80).to(dev)
    kv = r(1, 2, 20, 80).to(dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        wa.fused_window_attention_packed(q.half(), kv.half(), kv.half(),
                                         bias, None, 1.0, 4)
    with pytest.raises(ValueError, match="head dims"):
        wa.fused_window_attention_packed(q.bfloat16(), kv.bfloat16(),
                                         kv.bfloat16(), bias, None, 1.0, 4)


# (C, heads): every head dim the kernel takes, 8 to 64.
FACTOR_SHAPES = [(16, 2), (48, 4), (32, 2), (96, 4), (64, 2), (96, 2),
                 (128, 2)]


def _factor_attn_case(dev, c, heads, m, n_tok, masked, dtype, seed=9):
    """B6/B7/B8 operands whose bias has factors: the relative-position
    bias of an 8x8x(m/64) window (m 128 or 256: depth 2 or 4, as the
    factor form takes) with ``n_tok`` prompt columns, its
    BiasTables, y with the prompt rows the same in every window (as the
    unfused block's LN1 of the broadcast tokens), projected q/k/v."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    b, p, n = 2, 3, m + n_tok
    bias, factors = _bias_case(dev, g, heads, m, fb.FOLD_NONE, n_tok)
    tables = wa.BiasTables.from_factors(factors, bias)
    labels = None
    if masked:
        labels = torch.cat([torch.randint(0, 4, (p, m), generator=g),
                            torch.full((p, n_tok), -1)], 1)
        labels = labels.to(dev, torch.int32).contiguous()
    y = r(b, p, n, c)
    y[:, :, m:] = r(n_tok, c)
    ws = [(r(c, c) / c ** 0.5).to(dev) for _ in range(3)]
    qkv = [r(b, p, rows, c).to(dev, dtype) for rows in (m, n, n)]
    return y.to(dev, dtype), ws, qkv, bias, tables, labels


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", FACTOR_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_attention_factor_form_equals_dense_form(dev, c, heads,
                                                        masked, dtype):
    """The bias built in shared memory from its factors gives the dense
    form's output bit for bit, and so does B6 with the prompt rows apart
    (their K/V projected once per call); both within TOL of the plain
    versions; the factor launches are counted."""
    m, n_tok = 128, 5
    y, ws, (q, k, v), bias, tables, labels = _factor_attn_case(
        dev, c, heads, m, n_tok, masked, dtype)
    scale = (c // heads) ** -0.5
    split = lambda t: t.view(*t.shape[:3], heads, -1)  # noqa: E731
    before = (wa.fused_window_attention_packed_qkv.factor_launches,
              wa.fused_window_attention.factor_launches)
    with torch.inference_mode():
        ref6 = wa.fused_window_attention_packed_qkv_reference(
            y, *ws, m, bias, labels, scale, heads)
        dense6 = wa.fused_window_attention_packed_qkv(
            y, *ws, m, bias, labels, scale, heads)
        got6 = wa.fused_window_attention_packed_qkv(
            y, *ws, m, bias, labels, scale, heads, factors=tables)
        hoisted6 = wa.fused_window_attention_packed_qkv_prompts(
            y[:, :, :m].contiguous(), y[0, 0, m:].contiguous(), *ws, bias,
            labels, scale, heads, factors=tables)
        apart6 = wa.fused_window_attention_packed_qkv_prompts(
            y[:, :, :m].contiguous(), y[0, 0, m:].contiguous(), *ws, bias,
            labels, scale, heads)
        ref7 = wa.fused_window_attention_packed_reference(
            q, k, v, bias, labels, scale, heads)
        dense7 = wa.fused_window_attention_packed(q, k, v, bias, labels,
                                                  scale, heads)
        got7 = wa.fused_window_attention_packed(q, k, v, bias, labels, scale,
                                                heads, factors=tables)
        got8 = wa.fused_window_attention(split(q), split(k), split(v), bias,
                                         labels, scale, factors=tables)
        torch.cuda.synchronize()
    assert (wa.fused_window_attention_packed_qkv.factor_launches,
            wa.fused_window_attention.factor_launches) == (before[0] + 2,
                                                            before[1] + 1)
    assert got6.dtype == got7.dtype == dtype
    assert torch.equal(got6, dense6) and torch.equal(hoisted6, dense6)
    assert torch.equal(apart6, dense6)
    assert torch.equal(got7, dense7)
    assert torch.equal(got8.reshape(got7.shape), got7)
    _assert_close(got6, ref6)
    _assert_close(got7, ref7)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(48, 4), (96, 8), (96, 4), (192, 4),
                                     (192, 16)])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_flagship_repeats_and_plan(dev, c, heads, masked):
    """At the flagship window (M 256, 64 prompt rows) as the unfused block
    calls the kernel (B6 with the prompt rows apart, or B7/B8; the factor
    form): within TOL of the plain version, bit-identical to a second run,
    and launch_info agrees with attention_plan."""
    m, n_tok = 256, 64
    y, ws, (q, k, v), bias, tables, labels = _factor_attn_case(
        dev, c, heads, m, n_tok, masked, torch.bfloat16, seed=10)
    scale = (c // heads) ** -0.5
    n, tabw, proj = m + n_tok, tables.tab.shape[1], c <= 128
    with torch.inference_mode():
        if proj:
            yc, yp = y[:, :, :m].contiguous(), y[0, 0, m:].contiguous()
            run = lambda: wa.fused_window_attention_packed_qkv_prompts(  # noqa
                yc, yp, *ws, bias, labels, scale, heads, factors=tables)
            ref = wa.fused_window_attention_packed_qkv_reference(
                y, *ws, m, bias, labels, scale, heads)
        else:
            run = lambda: wa.fused_window_attention_packed(  # noqa: E731
                q, k, v, bias, labels, scale, heads, factors=tables)
            ref = wa.fused_window_attention_packed_reference(
                q, k, v, bias, labels, scale, heads)
        first = run()
        again = run()
        torch.cuda.synchronize()
    _assert_close(first, ref)
    assert torch.equal(again, first)
    info = wa.launch_info(6, m, n, c, heads, proj, factors=tables,
                          hoisted=True)
    plan = wa.attention_plan(m, n, c, heads, proj, proj, tabw)
    assert info["smem"] == plan.smem and info["cluster"] == 1
    assert info["threads"] == plan.threads
    assert info["ctas"] == 6 * heads
    assert info["ctas_per_sm"] >= 1 and info["registers"] <= 128


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
def test_window_attention_output_layer(dev, shift):
    """B6 on the Swin output layer's unfused blocks at batch 2 (C 48, 4
    heads, 128x128x8: 512 windows of M 256, N 320 per image; the shift on
    every axis, depth included), as the unfused block calls it (the prompt
    rows apart, the bias as its factors): within TOL of the plain version,
    and the launch counted at its shape."""
    c, heads, dims = OUTPUT_LAYER_BLOCK
    g = torch.Generator().manual_seed(16)
    blk = SwinTransformerBlock(c, (8, 8, 4), 64, heads, 1, 64,
                               shift_size=shift, pad_mode="aligned",
                               dtype=torch.bfloat16)
    blk = init_weights(blk, g).to(dev)
    blk.fused_block = False
    x = torch.randn((2, *dims, c), generator=g).to(dev, torch.bfloat16)
    tok = (0.5 * torch.randn((64, c), generator=g)).to(dev)
    at = blk.attn
    ws = [lin.weight.t() for lin in (at.to_q, at.to_k, at.to_v)]
    scale = (c // heads) ** -0.5
    counted = wa.fused_window_attention_packed_qkv.launches_by_shape
    with torch.inference_mode():
        x_win, ops, labels, _ = blk.windows(x, tok)
        y = blk.attn_input(x_win, tok)
        m = x_win.shape[2]
        ref = wa.fused_window_attention_packed_qkv_reference(
            y, *ws, m, ops.bias, labels, scale, heads)
        before = counted[(512, m, c)]
        got = wa.fused_window_attention_packed_qkv_prompts(
            y[:, :, :m].contiguous(), y[0, 0, m:].contiguous(), *ws,
            ops.bias, labels, scale, heads, wqkv=at.kernel_weight(),
            factors=ops.factors)
        torch.cuda.synchronize()
    assert tuple(x_win.shape[:3]) == (2, 512, 256)
    assert (labels is not None) == any(shift) and ops.factors is not None
    assert counted[(512, m, c)] == before + 1
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ci,co", [
    ((2, 6, 5, 4), 16, 16), ((1, 8, 8, 2), 48, 48), ((3, 5, 7, 3), 32, 48),
    ((1, 16, 16, 2), 192, 96)])
@pytest.mark.parametrize("affine,leaky", [(True, True), (False, False),
                                          (True, False), (False, True)])
def test_conv3x3_one_input_kernel_matches_plain(dev, shape, ci, co, affine,
                                                leaky):
    g = torch.Generator().manual_seed(2)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x = r(*shape, ci).to(dev, torch.bfloat16)
    w = (r(co, ci, 3, 3, 3) / (27 * ci) ** 0.5).to(dev)
    bias = (0.1 * r(co)).to(dev)
    scale = (0.5 + torch.rand(ci, generator=g)).to(dev) if affine else None
    shift = (2.0 + 0.3 * r(ci)).to(dev) if affine else None
    with torch.inference_mode():
        ref = cf.conv_reference(x, w, bias, scale, shift, leaky)
        before = cf.conv3x3_fused.launches
        got = cf.conv3x3_fused(x, w, bias, scale, shift, leaky)
        torch.cuda.synchronize()
    assert cf.conv3x3_fused.launches == before + 1
    assert got.shape == (*shape, co) and got.dtype == torch.bfloat16
    _assert_close(got, ref)


# (C, heads, spatial dims, window, prompt tokens): a window-permuted
# shift, the flagship's 64x64x4 stage (M 256, 64 tokens), its pad-folded
# 32x32x2 and 16x16x2 stages (FOLD_KEY then FOLD_COUNT, M 128), and an
# unshifted pair (the shift zeroed where the extent equals the window).
PAIR_CASES = [(16, 2, (16, 16, 4), (4, 4, 4), 3),
              (48, 4, (64, 64, 4), (8, 8, 4), 64),
              (96, 8, (32, 32, 2), (8, 8, 4), 64),
              (192, 4, (16, 16, 2), (8, 8, 4), 64),
              (32, 2, (4, 4, 4), (4, 4, 4), 0)]
PAIR_DROP = (fb.Dropout((31, 32), 0.1, 0.1), fb.Dropout((33, 34), 0.1, 0.1))


def _pair_case(dev, c, heads, dims, window, n_tok, seed=7):
    g = torch.Generator().manual_seed(seed)
    pair = ConsecutiveSwinBlocks(c, heads, 8, 1, max(n_tok, 1), window,
                                 down=False, pad_mode="aligned",
                                 dtype=torch.bfloat16)
    pair = init_weights(pair, g).to(dev)
    pair.pair_kernel = True
    x = torch.randn((2, *dims, c), generator=g).to(dev, torch.bfloat16)
    toks = tuple((0.5 * torch.randn((n_tok, c), generator=g)).to(dev)
                 if n_tok else None for _ in range(2))
    with torch.no_grad():
        call = pair.pair_windows(x, toks)
    assert call is not None
    return call[:5]


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims,window,n_tok", PAIR_CASES)
@pytest.mark.parametrize("dropout", [False, True])
def test_pair_kernel_matches_plain_and_equals_two_launches(
        dev, c, heads, dims, window, n_tok, dropout):
    x_win, ops0, ops1, labels, plan = _pair_case(dev, c, heads, dims, window,
                                                 n_tok)
    d0, d1 = PAIR_DROP if dropout else (fb.NO_DROPOUT, fb.NO_DROPOUT)
    with torch.inference_mode():
        ref = fp.pair_reference(x_win, ops0, ops1, labels, plan, d0, d1)
        before = fp.fused_swin_pair.launches
        got = fp.fused_swin_pair(x_win, ops0, ops1, labels, plan, d0, d1)
        torch.cuda.synchronize()
        assert fp.fused_swin_pair.launches == before + 1
        x1 = fb.fused_swin_block(x_win, ops0, None, d0)
        x2 = fb.fused_swin_block(fp.plan_gather(x1, plan.index), ops1,
                                 labels, d1)
        chain = fp.plan_gather(x2, plan.inverse)
    assert got.dtype == torch.bfloat16 and got.shape == x_win.shape
    _assert_close(got, ref)
    assert torch.equal(got, chain), int((got != chain).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims,window,n_tok", PAIR_CASES[:4])
def test_pair_backward_kernels_match_plain(dev, c, heads, dims, window,
                                           n_tok):
    x_win, ops0, ops1, labels, plan = _pair_case(dev, c, heads, dims, window,
                                                 n_tok, seed=8)
    dout = torch.randn(x_win.shape, generator=torch.Generator().manual_seed(
        9)).to(dev, torch.bfloat16)
    counts = (fb.fused_swin_block.launches, fbb.block_backward.launches)
    dx, got0, got1 = fp.pair_backward(x_win, dout, ops0, ops1, labels, plan,
                                      *PAIR_DROP)
    torch.cuda.synchronize()
    assert (fb.fused_swin_block.launches, fbb.block_backward.launches) == \
        (counts[0] + 1, counts[1] + 2)
    x = x_win.detach().requires_grad_()
    leaves = [[None if t is None else t.detach().requires_grad_()
               for t in ops.tensors()] for ops in (ops0, ops1)]
    with torch.enable_grad():
        out = fp.pair_reference(x, ops0.with_tensors(leaves[0]),
                                ops1.with_tensors(leaves[1]), labels, plan,
                                *PAIR_DROP)
    flat = [t for t in leaves[0] + leaves[1] if t is not None]
    want = iter(torch.autograd.grad(out, [x] + flat, dout, allow_unused=True))
    names = ["x", "bias", "ext_k", "ext_v", *fb.PARAM_KEYS]
    for blk, got in ((None, (dx,)), (0, got0), (1, got1)):
        for i, g in enumerate(got):
            name = "x" if blk is None else f"block {blk} {names[i + 1]}"
            if g is None:
                continue
            r = next(want)
            g, r = g.float(), torch.zeros_like(g.float()) if r is None \
                else r.float()
            assert torch.isfinite(g).all(), name
            err = (g - r).abs().max().item()
            scale = r.abs().max().item()
            assert err <= GRAD_TOL * max(scale, 1e-6), (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims,window,n_tok", PAIR_CASES[:4])
def test_pair_kernel_takes_fp32(dev, c, heads, dims, window, n_tok):
    """fp32 x_win: block 1's output stays fp32 in the CTA's slot (the JAX
    kernel rounds it to the array dtype), so B5 still equals B1 + gather
    + B1 + gather element for element."""
    x_win, ops0, ops1, labels, plan = _pair_case(dev, c, heads, dims, window,
                                                 n_tok, seed=12)
    x_win = x_win.float() + 1e-3 * torch.randn(x_win.shape, device=dev)
    with torch.inference_mode():
        ref = fp.pair_reference(x_win, ops0, ops1, labels, plan)
        got = fp.fused_swin_pair(x_win, ops0, ops1, labels, plan)
        x1 = fb.fused_swin_block(x_win, ops0, None)
        chain = fp.plan_gather(fb.fused_swin_block(
            fp.plan_gather(x1, plan.index), ops1, labels), plan.inverse)
        torch.cuda.synchronize()
    assert got.dtype == torch.float32
    _assert_close(got, ref)
    assert torch.equal(got, chain), int((got != chain).sum())


@pytest.mark.cuda
def test_pair_kernel_rejects_bad_calls(dev):
    x_win, ops0, ops1, labels, plan = _pair_case(dev, *PAIR_CASES[0])
    with pytest.raises(ValueError, match="x_win must be float32 or bfloat16"):
        fp.fused_swin_pair(x_win.half(), ops0, ops1, labels, plan)
    cpu_plan = plan._replace(src=plan.src.cpu())
    with pytest.raises(ValueError, match="plan.src must be"):
        fp.fused_swin_pair(x_win, ops0, ops1, labels, cpu_plan)


# The backward of B6/B7/B8 is the JAX package's fp32 recompute in plain
# torch: against autograd of the plain version at fp32 (TF32 off) it
# differs by float reassociation only.
ATTN_GRAD_TOL = 2.0 ** -10


def _grads_of(fn, inputs, g):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out.backward(g)
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(48, 4), (96, 8), (96, 4), (192, 16),
                                     (192, 4)])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_function_gradients_match_plain(dev, c, heads,
                                                         masked):
    """At the flagship unfused calls' window (M 256, 64 prompt rows, the
    factor form): B6 with the prompt rows apart (C <= 128) or B8 (C 192),
    and B7 at C 96, through their autograd Functions: the forward equals
    the inference call bit for bit, and every gradient (y or q/k/v, the
    prompt rows, the weights, the bias) is within ATTN_GRAD_TOL of the
    largest magnitude of autograd's through the fp32 plain version."""
    m, n_tok = 256, 64
    y, ws, (q, k, v), bias, tables, labels = _factor_attn_case(
        dev, c, heads, m, n_tok, masked, torch.bfloat16, seed=21)
    scale = (c // heads) ** -0.5
    gen = torch.Generator().manual_seed(22)
    g = torch.randn((2, 3, m, c), generator=gen).to(dev)
    calls = []
    if c <= 128:
        yc, yp = y[:, :, :m].contiguous(), y[0, 0, m:].contiguous()

        def b6(yc, yp, wq, wk, wv, bias):
            return wa.fused_window_attention_packed_qkv_prompts(
                yc, yp, wq, wk, wv, bias, labels, scale, heads,
                factors=tables)

        def b6_plain(yc, yp, wq, wk, wv, bias):
            full = torch.cat([yc, yp.expand(2, 3, -1, c)], 2)
            return wa.fused_window_attention_packed_qkv_reference(
                full, wq, wk, wv, m, bias, labels, scale, heads,
                torch.float32)

        calls.append((b6, b6_plain, [yc, yp, *ws, bias]))
    if c == 96 or c > 128:
        split = lambda t: t.view(2, 3, t.shape[2], heads, -1)  # noqa: E731

        def b7(q, k, v, bias):
            return wa.fused_window_attention_packed(
                q, k, v, bias, labels, scale, heads, factors=tables)

        def b8(q, k, v, bias):
            return wa.fused_window_attention(
                split(q), split(k), split(v), bias, labels, scale,
                factors=tables).reshape(2, 3, m, c)

        def attn_plain(q, k, v, bias):
            return wa.fused_window_attention_packed_reference(
                q, k, v, bias, labels, scale, heads, torch.float32)

        calls.append((b7 if c == 96 else b8, attn_plain, [q, k, v, bias]))
    for fn, plain, inputs in calls:
        with torch.inference_mode():
            served = fn(*inputs)
        out, got = _grads_of(fn, inputs, g.to(served.dtype))
        assert torch.equal(out, served)
        assert all(a.dtype == t.dtype for a, t in zip(got, inputs))
        # The gradients at fp32 (the bf16 values widened; the kernel
        # rounds its operands to bf16 as before): a bf16 gradient's last
        # rounding alone may exceed ATTN_GRAD_TOL.
        wide = [t.float() for t in inputs]
        _, got = _grads_of(fn, wide, g)
        _, want = _grads_of(plain, wide, g)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.isfinite(a).all(), i
            scale_i = b.abs().max().item()
            err = (a - b).abs().max().item()
            assert scale_i > 0 and err <= ATTN_GRAD_TOL * scale_i, \
                (fn.__name__, i, err, scale_i)


@pytest.mark.cuda
@pytest.mark.parametrize("attn_drop", [0.0, 0.1])
@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_unfused_training_step_launches(dev, attn_drop, use_checkpoint):
    """One step of the flagship model (batch 2 of 128x128x8) through the
    unfused blocks in train mode, projection dropout 0.1: 8 B6 + 4 B8
    launches with attention dropout 0 (16 + 8 with ``use_checkpoint``:
    the recompute launches each forward kernel again), none with
    attention dropout 0.1 (the JAX XLA branch); no B1/B4/B5; every
    trainable gradient finite."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import flagship_conf
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    model = SwinUnetR(flagship_conf(attn_drop=attn_drop, proj_drop=0.1,
                                    use_checkpoint=use_checkpoint))
    init_weights(model, torch.Generator().manual_seed(23))
    model = model.to(dev).set_fused_block(False).train()
    x = torch.randn((2, 128, 128, 8, 1),
                    generator=torch.Generator().manual_seed(24)).to(dev)
    fns = {"B6": wa.fused_window_attention_packed_qkv,
           "B7": wa.fused_window_attention_packed,
           "B8": wa.fused_window_attention, "B1": fb.fused_swin_block,
           "B4": fbb.block_backward, "B5": fp.fused_swin_pair}
    before = {k: f.launches for k, f in fns.items()}
    (model(x).float() ** 2).mean().backward()
    torch.cuda.synchronize()
    got = {k: f.launches - before[k] for k, f in fns.items()}
    per = 0 if attn_drop else (2 if use_checkpoint else 1)
    assert got == {"B6": 8 * per, "B7": 0, "B8": 4 * per, "B1": 0,
                   "B4": 0, "B5": 0}, got
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(t).all() for t in grads)


# Data parallel: a rank holding rows [r*b, (r+1)*b) of a global batch
# passes the global index of its first window (Dropout.win_base) to
# B1, B5 and B4, so that it hashes the global batch's masks.
WIN_BASE_CASES = [(48, 4, 64, fb.FOLD_NONE, True, 5),
                  (96, 8, 100, fb.FOLD_KEY, False, 7),
                  (192, 4, 128, fb.FOLD_COUNT, True, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,m,fold_mode,shifted,n_tok", WIN_BASE_CASES)
def test_fused_swin_block_at_a_window_base(dev, c, heads, m, fold_mode,
                                           shifted, n_tok):
    """B1 with dropout on samples [1:] at win_base = P equals rows [1:]
    of the whole call bit for bit, and on samples [:1] at base 0 rows
    [:1]; at base P it is held to the plain version at the same base."""
    x, ops, labels = _block_case(dev, 3, 3, m, c, heads, fold_mode, shifted,
                                 n_tok, seed=5)
    p = x.shape[1]
    with torch.inference_mode():
        whole = fb.fused_swin_block(x, ops, labels, DROP)
        head = fb.fused_swin_block(x[:1].contiguous(), ops, labels, DROP)
        tail = fb.fused_swin_block(x[1:].contiguous(), ops, labels,
                                   DROP.at(p))
        unbased = fb.fused_swin_block(x[1:].contiguous(), ops, labels, DROP)
        ref = fb.block_reference(x[1:].contiguous(), ops, labels, DROP.at(p))
        torch.cuda.synchronize()
    assert torch.equal(head, whole[:1]) and torch.equal(tail, whole[1:])
    assert not torch.equal(unbased, whole[1:])
    _assert_close(tail, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,dims,window,n_tok", PAIR_CASES[1:4])
def test_pair_kernel_at_a_window_base(dev, c, heads, dims, window, n_tok):
    """B5 with dropout on sample [1:] at win_base = P: rows [1:] of the
    whole call bit for bit; the plain version at the same base."""
    x_win, ops0, ops1, labels, plan = _pair_case(dev, c, heads, dims, window,
                                                 n_tok, seed=6)
    p = x_win.shape[1]
    d0, d1 = PAIR_DROP
    part = x_win[1:].contiguous()
    with torch.inference_mode():
        whole = fp.fused_swin_pair(x_win, ops0, ops1, labels, plan, d0, d1)
        head = fp.fused_swin_pair(x_win[:1].contiguous(), ops0, ops1, labels,
                                  plan, d0, d1)
        tail = fp.fused_swin_pair(part, ops0, ops1, labels, plan, d0.at(p),
                                  d1.at(p))
        ref = fp.pair_reference(part, ops0, ops1, labels, plan, d0.at(p),
                                d1.at(p))
        torch.cuda.synchronize()
    assert torch.equal(head, whole[:1]) and torch.equal(tail, whole[1:])
    _assert_close(tail, ref)
    with pytest.raises(ValueError, match="one base"):
        fp.fused_swin_pair(part, ops0, ops1, labels, plan, d0.at(p), d1)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,m,fold_mode,shifted,n_tok", WIN_BASE_CASES)
def test_block_backward_at_a_window_base(dev, c, heads, m, fold_mode,
                                         shifted, n_tok):
    """B4 with dropout on samples [1:] at win_base = P: dx is rows [1:]
    of the whole call's bit for bit (each window's own), every gradient
    is held to the plain version at the same base, and the two ranks'
    operand gradients (samples [:1] at base 0, [1:] at base P) add up to
    the whole call's within GRAD_TOL."""
    x, ops, labels = _block_case(dev, 3, 3, m, c, heads, fold_mode, shifted,
                                 n_tok, seed=6)
    p = x.shape[1]
    dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(10)
                       ).to(dev, torch.bfloat16)
    dx, whole = fbb.block_backward(x, dout, ops, labels, DROP)
    dx0, head = fbb.block_backward(x[:1].contiguous(), dout[:1].contiguous(),
                                   ops, labels, DROP)
    dx1, tail = fbb.block_backward(x[1:].contiguous(), dout[1:].contiguous(),
                                   ops, labels, DROP.at(p))
    ref_dx, ref = fbb.block_backward_reference(
        x[1:].contiguous(), dout[1:].contiguous(), ops, labels, DROP.at(p))
    torch.cuda.synchronize()
    assert torch.equal(dx0, dx[:1]) and torch.equal(dx1, dx[1:])
    names = ["x", "bias", "ext_k", "ext_v", *fb.PARAM_KEYS]
    for name, g, r, w, h in zip(names, (dx1, *tail), (ref_dx, *ref),
                                (dx[1:], *whole), (dx0, *head)):
        if r is None:
            assert g is None, name
            continue
        for got, want in ((g, r), (g if name == "x" else g + h,
                                   w if name == "x" else w)):
            got, want = got.float(), want.float()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            assert err <= GRAD_TOL * max(scale, 1e-6), (name, err, scale)


@pytest.mark.cuda
def test_flop_counts_match_the_bf16_plain_forward_on_the_card(dev):
    """``utils/flops.py`` at the flagship, one 128x128x8 window: the
    port's count as executed is ``FlopCounterMode``'s of the bf16 plain
    forward on the card (fresh operand caches), the model count is what
    ``model_flops`` returns."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import flagship_conf
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import flops
    model = SwinUnetR(flagship_conf())
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval().set_kernels(False)
    x = torch.rand((1, 128, 128, 8, 1), generator=torch.Generator()
                   .manual_seed(1)).to(dev)
    count = flops.forward_flops(flagship_conf(), 1, roi=(128, 128, 8))
    assert flops.counted_flops(model, x) == count.port
    assert flops.model_flops(flagship_conf(), roi=(128, 128, 8)) == \
        count.model


# (per-sample input shape, scale, crop) of the serving forward's upsamples
# (the three SwinUpBlocks), then an odd crop and align_corners=True.
UPSAMPLE_CASES = [((8, 8, 2, 384), (2, 2, 1), (16, 16, 2), False),
                  ((16, 16, 2, 192), (2, 2, 1), (32, 32, 2), False),
                  ((32, 32, 2, 96), (2, 2, 2), (64, 64, 4), False),
                  ((5, 7, 3, 16), (2, 2, 2), (9, 13, 5), False),
                  ((8, 8, 2, 48), (2, 2, 2), (16, 16, 4), True)]


def _head_case(dev, c, k, seed=2):
    """Folded BatchNorm and a conv for the head form (``ops/upsample.py::
    Head`` fields but the dtype)."""
    g = torch.Generator().manual_seed(seed)
    scale = (0.5 + torch.rand(c, generator=g)).to(dev)
    shift = torch.randn(c, generator=g).to(dev)
    w = (torch.randn((k, c, 3, 3, 3), generator=g) / (27 * c) ** 0.5).to(dev)
    bias = (0.1 * torch.randn(k, generator=g)).to(dev)
    return scale, shift, w, bias


@pytest.mark.cuda
@pytest.mark.parametrize("shape,scale,crop,align_corners", UPSAMPLE_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_upsample_kernel_matches_plain(dev, shape, scale, crop,
                                       align_corners, dtype):
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import upsample as up
    x = torch.randn((4, *shape), generator=torch.Generator().manual_seed(1))
    x = x.to(dev, dtype)
    with torch.inference_mode():
        ref = up.upsample_reference(x, scale, crop, align_corners)
        before = up.upsample.launches
        got = up.upsample(x, scale, crop, align_corners)
        torch.cuda.synchronize()
    assert up.upsample.launches == before + 1
    assert got.shape == (4, *crop, shape[-1]) and got.dtype == dtype
    assert got.is_contiguous()
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("head", [False, True])
def test_upsample_kernel_takes_a_strided_input(dev, head):
    """A channels-last view of a channels-first tensor (as the unfused
    blocks hand the decoder a strided tensor) gives what its contiguous
    copy gives, in both forms."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import upsample as up
    x = torch.randn((2, 48, 16, 16, 4), generator=torch.Generator()
                    .manual_seed(5)).to(dev, torch.bfloat16)
    x = x.permute(0, 2, 3, 4, 1)
    hd = up.Head(*_head_case(dev, 48, 2), torch.bfloat16) if head else None
    crop = None if head else (31, 32, 7)
    with torch.inference_mode():
        got = up.upsample(x, (2, 2, 2), crop, head=hd)
        want = up.upsample(x.contiguous(), (2, 2, 2), crop, head=hd)
        torch.cuda.synchronize()
    assert not x.is_contiguous() and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,classes,x_dtype,head_dtype", [
    ((4, 64, 64, 4, 48), 2, torch.bfloat16, torch.bfloat16),
    ((4, 64, 64, 4, 48), 2, torch.float32, torch.float32),
    ((2, 64, 64, 4, 48), 2, torch.float32, torch.bfloat16),
    ((2, 13, 9, 5, 16), 5, torch.bfloat16, torch.bfloat16)])
def test_upsample_head_kernel_matches_plain(dev, shape, classes, x_dtype,
                                            head_dtype):
    """The head form against the einsum upsample, BatchNorm, cast, cuDNN
    conv and ``.float()`` on the card, window borders included (the
    conv's zero padding); 5 classes take two launches.  fp32: the
    reference conv runs without TF32 (the ``dev`` fixture), so the bound
    is the bf16 one, far above the sum order's differences; with TF32 (a
    serving default of cuDNN) the plain head keeps 10 mantissa bits."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import upsample as up
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    x = x.to(dev, x_dtype)
    head = up.Head(*_head_case(dev, shape[-1], classes), head_dtype)
    with torch.inference_mode():
        ref = up.upsample_reference(x, (2, 2, 2), head=head)
        before = up.upsample.launches
        got = up.upsample(x, (2, 2, 2), head=head)
        torch.cuda.synchronize()
    assert up.upsample.launches == before + -(-classes // up.MAX_CLASSES)
    assert got.shape == ref.shape and got.dtype == torch.float32
    _assert_close(got, ref)


@pytest.mark.cuda
def test_upsample_flagship_eval_forward_launches_and_no_sync(dev):
    """An eval forward of the flagship model runs the kernel 4 times (the
    three up blocks' plain form, the head form at the end), and nothing
    under it waits for the card (no ``cudaStreamSynchronize``)."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import flagship_conf
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import upsample as up
    model = SwinUnetR(flagship_conf())
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    x = torch.rand((2, 128, 128, 8, 1), generator=torch.Generator()
                   .manual_seed(1)).to(dev)
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        up.upsample.launches_by_shape.clear()
        before = up.upsample.launches
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            y = model(x)
        torch.cuda.synchronize()
    assert y.shape == (2, 128, 128, 8, 2) and torch.isfinite(y).all()
    assert up.upsample.launches == before + 4
    assert dict(up.upsample.launches_by_shape) == {
        ((8, 8, 2, 384), (16, 16, 2, 384), "plain"): 1,
        ((16, 16, 2, 192), (32, 32, 2, 192), "plain"): 1,
        ((32, 32, 2, 96), (64, 64, 4, 96), "plain"): 1,
        ((64, 64, 4, 48), (128, 128, 8, 2), "head"): 1}
    names = [e.name for e in prof.events()]
    assert "cudaStreamSynchronize" not in names
    assert sum("upsample" in n for n in names) >= 4


# MedSAM's encoder attention core (S1, ``ops/sam_attention.py``) at the
# published calls of a 16-slice batch: the global blocks' 16 64x64 grids
# and the windowed blocks' 400 14x14 windows, 12 heads of 64.
SAM_CALLS = [(16, 64, 64), (400, 14, 14)]


def _sam_case(dev, b, h, w, dtype, seed=1):
    """qkv ~ N(0, 1) and the two gathered rel-pos tables drawn as
    ``benchmark/generate.py`` draws the tables (sd 0.10 for the global
    blocks' 127 rows, 0.15 for the windows' 27): q . R as large as q . k
    / 8."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, h, w, 3 * 12 * 64, generator=g).to(dev, dtype)

    def table(side):
        r = (0.10 if side == 64 else 0.15) * torch.randn(2 * side - 1, 64,
                                                          generator=g)
        pos = torch.arange(side)
        return r[pos[:, None] - pos[None, :] + side - 1].contiguous().to(
            dev, dtype)
    return qkv, table(h), table(w)


def _sam_plain_fp32(sa, qkv, th, tw):
    """The plain version in fp32 on the same (rounded) inputs, a few
    images at a time (its scores are materialised by SDPA's math path)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    step = 4 if qkv.shape[1] == 64 else 100
    with sdpa_kernel(SDPBackend.MATH):
        return torch.cat([sa.sam_attention_reference(
            qkv[i:i + step].float(), th.float(), tw.float(), 12)
            for i in range(0, qkv.shape[0], step)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w", SAM_CALLS, ids=["global", "windows"])
def test_sam_attention_kernel_matches_plain(dev, b, h, w, dtype):
    """The kernel against the plain version computed in fp32 on the same
    inputs.  bf16: the kernel rounds P to bf16 before PV (each weight by
    at most 2^-9 relative, so o by at most 2^-9 max|v|) and o to bf16
    (2^-9 |o| <= 2^-9 max|v|); its scores, bias and softmax are fp32, so
    2^-8 max|v| bounds the difference.  fp32: the same arithmetic with
    sums of up to 4,096 terms in another order, a few fp32 ulps: 1e-5
    max|v| leaves tenfold room.  Two runs give the same bits."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import sam_attention as sa
    qkv, th, tw = _sam_case(dev, b, h, w, dtype)
    with torch.inference_mode():
        before = sa.sam_attention.launches
        got = sa.sam_attention(qkv, th, tw, 12)
        again = sa.sam_attention(qkv, th, tw, 12)
        torch.cuda.synchronize()
        ref = _sam_plain_fp32(sa, qkv, th, tw)
    assert sa.sam_attention.launches == before + 2
    assert got.shape == (b, h, w, 768) and got.dtype == dtype
    assert torch.equal(got, again)
    vmax = qkv[..., 2 * 768:].float().abs().max().item()
    tol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    assert torch.isfinite(got).all()
    err = (got.float() - ref).abs().max().item()
    assert err <= tol * vmax, (err, vmax)


@pytest.mark.cuda
def test_sam_attention_launch_shapes(dev):
    """The global calls launch three consumer warpgroups and a producer
    warp (416 threads, 192 query rows a CTA, one CTA an SM), the windows
    two (288 threads, two CTAs an SM); no spills."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import sam_attention as sa
    infos = [sa.launch_info(torch.empty(b, h, w, 3 * 768, device=dev,
                                        dtype=torch.bfloat16), 12)
             for b, h, w in SAM_CALLS]
    assert [i["form"] for i in infos] == ["rows", "windows"]
    assert [i["ctas"] for i in infos] == [16 * 12 * 22, 400 * 12 * 2]
    assert [i["threads"] for i in infos] == [416, 288]
    assert all(i["spill_bytes"] == 0 for i in infos)
    assert [i["ctas_per_sm"] for i in infos] == [1, 2]


@pytest.mark.cuda
def test_sam_served_study_takes_24_launches_and_no_sdpa_in_the_encoder(dev):
    """A 32-slice study of the shipped bf16 MedSAM through the serving
    path: two encoder forwards of 16 slices, 12 attention cores each, all
    through the kernel; ``scaled_dot_product_attention`` runs only in the
    mask decoder."""
    import numpy as np
    import torch.nn.functional as F
    from pathlib import Path
    from medical_image_segmentation_with_visual_prompts_tpu_torch import infer
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import load_conf
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import sam_attention as sa
    root = Path(__file__).resolve().parent.parent
    conf = load_conf(str(root / "configurations" / "medsam_vit_b.yml"))
    model = infer.build_model(conf)
    runner = infer.make_runner(conf, model)
    vol = np.random.default_rng(3).normal(40.0, 150.0, (96, 80, 40)).astype(
        np.int16)[..., None]
    box = (10, 6, 70, 60, 4, 36)
    infer.predict_device(runner, None, vol, box=box)       # warm-up
    torch.cuda.synchronize()
    calls = {"encoder": 0, "other": 0}
    inside = [False]
    real = F.scaled_dot_product_attention

    def counted(*args, **kw):
        calls["encoder" if inside[0] else "other"] += 1
        return real(*args, **kw)
    enc = model.image_encoder
    hooks = [enc.register_forward_pre_hook(
                 lambda *_: inside.__setitem__(0, True)),
             enc.register_forward_hook(
                 lambda *_: inside.__setitem__(0, False))]
    F.scaled_dot_product_attention = counted
    try:
        before = sa.sam_attention.launches
        labels, _ = infer.predict_device(runner, None, vol, box=box)
        torch.cuda.synchronize()
    finally:
        F.scaled_dot_product_attention = real
        for hk in hooks:
            hk.remove()
    assert sa.sam_attention.launches - before == 24
    assert calls["encoder"] == 0 and calls["other"] > 0
    assert labels.shape == (96, 80, 40)
