"""PyTorch port: the host side of the window-attention kernels (B6/B7/B8)
on the CPU.

The kernels run on the card only (``tests/test_torch_kernels_cuda.py``).
Here: the bias tables that the unfused block passes them in place of the
``[H, M, N]`` array rebuild that array bit for bit through ``table_bias``
(the kernel's indexing and order of operations), at the flagship's
unfused geometries, shifted and not, built without running any block; the
launch plan (``attention_plan``: threads, shared bytes, CTAs per SM) as a
pure function of the shapes; the plain path, which ignores the factor
tables; and B6 with the prompt rows apart (the unfused block's call),
which equals B6 on the whole windows.
"""

import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinTransformerBlock
from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
    .swin_block import UnfusedOperands
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block as fb
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    window_attention as wa
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    init_weights

# (C, heads, dims) of the flagship's unfused block calls: every stage pads
# to the 8x8x4 window (M 256) and carries 64 prompt tokens (N 320).
UNFUSED = [(48, 4, (64, 64, 4)), (96, 8, (32, 32, 2)),
           (192, 16, (16, 16, 2)), (192, 4, (16, 16, 2)),
           (96, 4, (32, 32, 2))]


@pytest.mark.parametrize("c,heads,dims", UNFUSED)
@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 4, 2)])
def test_unfused_factors_rebuild_the_dense_bias(c, heads, dims, shift):
    g = torch.Generator().manual_seed(sum(dims) + c + heads)
    blk = SwinTransformerBlock(c, (8, 8, 4), 64, heads, 1, 64,
                               shift_size=shift, pad_mode="aligned")
    blk = init_weights(blk, g).eval()
    blk.fused_block = False
    tokens = torch.randn((64, c), generator=g)
    with torch.no_grad():
        _, _, ops, labels, _ = blk.operands(torch.zeros((1, *dims, c)),
                                            tokens)
    assert isinstance(ops, UnfusedOperands)
    assert (labels is not None) == any(shift)
    tables = ops.factors
    assert tables.dims == (8, 8, 4) and tables.scale == blk.pe.scale
    assert tables.tab.shape == (heads, 64 + 64 + 16 + 64)
    assert tables.coord.shape == (256,) and tables.coord.dtype == torch.int32
    assert ops.bias.shape == (heads, 256, 320)
    assert torch.equal(fb.table_bias(tables.tab, tables.coord, tables.dims,
                                     256, 320, False, tables.scale),
                       ops.bias)
    assert torch.equal(tables.dense(320), ops.bias)


def test_factor_form_takes_whole_windows_of_depth_2_4_8():
    """Other windows keep the dense form: the unfused block passes no
    factors for them, and BiasTables refuses their factors."""
    g = torch.Generator().manual_seed(5)
    blk = SwinTransformerBlock(16, (4, 4, 3), 8, 2, 1, 3, pad_mode="aligned")
    blk = init_weights(blk, g).eval()
    blk.fused_block = False
    with torch.no_grad():
        _, _, ops, _, _ = blk.operands(torch.zeros((1, 8, 8, 6, 16)))
    assert ops.factors is None and ops.bias.shape == (2, 48, 48)
    axes = tuple(torch.randn(2, d, d, generator=g) for d in (4, 4, 4))
    bias = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="whole window"):
        wa.BiasTables.from_factors(
            fb.BiasFactors(axes, torch.arange(1, 65) % 64, 0.5), bias)
    with pytest.raises(ValueError, match="whole window"):
        wa.BiasTables.from_factors(
            fb.BiasFactors(axes[:2] + (torch.randn(2, 1, 1),),
                           torch.arange(16), 0.5), bias[:, :16, :16])


def test_unfused_factors_without_prompt_tokens():
    blk = SwinTransformerBlock(16, (4, 4, 4), 8, 2, 1, 3,
                               shift_size=(2, 2, 2), pad_mode="aligned")
    blk = init_weights(blk, torch.Generator().manual_seed(3)).eval()
    blk.fused_block = False
    with torch.no_grad():
        _, _, ops, _, _ = blk.operands(torch.zeros((1, 8, 8, 6, 16)))
    assert ops.factors.tab.shape == (2, 16 + 16 + 16)
    assert torch.equal(ops.factors.dense(64), ops.bias)


def _smem(yrows, c, dhk, tabw, m=256, npad=320):
    """The kernel's Smem layout written out: y, Q (B6 at head dims up to
    16), K, V^T, labels, table (16 floats of slack), coordinates."""
    a16 = lambda v: -(-v // 16) * 16  # noqa: E731
    off = a16(yrows * (c + 8) * 2)
    if yrows and dhk == 16:
        off = a16(off + m * (dhk + 8) * 2)
    off = a16(off + npad * (dhk + 8) * 2)
    off = a16(off + dhk * (npad + 8) * 2)
    off = a16(off + npad * 4)
    if tabw:
        off = a16(a16(off + (tabw + 16) * 4) + m * 4)
    return off


# (name, C, heads, B6?, windows of the 27-window batch, (threads, smem,
# CTAs per SM) the plan picks, the 64 prompt rows apart (B6), the bias as
# its 208-float table)
FLAGSHIP = [
    ("enc0", 48, 4, True, 1728, (256, 70016, 3)),
    ("enc1", 96, 8, True, 432, (256, 94592, 2)),
    ("dec1", 96, 4, True, 432, (256, 103040, 2)),
    ("enc2", 192, 16, False, 108, (256, 29056, 3)),
    ("dec0", 192, 4, False, 108, (256, 70528, 2)),
]


@pytest.mark.parametrize("name,c,heads,proj,bp,want", FLAGSHIP)
def test_attention_plan_flagship(name, c, heads, proj, bp, want):
    plan = wa.attention_plan(256, 320, c, heads, proj, proj, 208)
    assert (plan.threads, plan.smem, plan.ctas_per_sm) == want, plan
    dhk = -(-(c // heads) // 16) * 16
    assert plan.smem == _smem(256 if proj else 0, c, dhk, 208)
    # Two CTAs per SM or more at every call (dec1 held one before: its
    # Q is no longer staged, nor the prompt rows of y).
    assert plan.ctas_per_sm >= 2
    # The dense form and the whole-window B6 need more shared memory.
    assert wa.attention_smem(256, 320, c, heads, proj, False, 0) < \
        wa.attention_smem(256, 320, c, heads, proj, False, 208)
    if proj:
        assert wa.attention_smem(256, 320, c, heads, True, False, 208) == \
            _smem(320, c, dhk, 208)


@pytest.mark.parametrize("name,c,heads,proj,bp,want", FLAGSHIP)
def test_attention_plan_is_a_function_of_the_shapes(name, c, heads, proj,
                                                    bp, want):
    """Same shapes, same plan; a warp per 32 query rows, at most 8."""
    args = (256, 320, c, heads, proj, proj, 208)
    assert wa.attention_plan(*args) == wa.attention_plan.__wrapped__(*args)
    for m, threads in ((16, 32), (64, 64), (128, 128), (512, 256)):
        plan = wa.attention_plan(m, m + 64, c, heads, proj, proj)
        assert plan.threads == threads
        assert plan.smem == wa.attention_smem(m, m + 64, c, heads, proj,
                                              proj)


def test_attention_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="shared bytes"):
        wa.attention_plan(1024, 1100, 1024, 16, True)


def _unfused_case(seed=4):
    g = torch.Generator().manual_seed(seed)
    blk = SwinTransformerBlock(16, (4, 4, 4), 8, 2, 1, 3,
                               shift_size=(2, 2, 2), pad_mode="aligned")
    blk = init_weights(blk, g).eval()
    blk.fused_block = False
    tok = torch.randn((3, 16), generator=g)
    x = torch.randn((1, 8, 8, 4, 16), generator=g)
    with torch.no_grad():
        x_win, ops, labels, _ = blk.windows(x, tok)
        y = blk.attn_input(x_win, tok)
    return blk, y, x_win.shape[2], ops, labels, (x, tok)


def test_plain_path_ignores_the_factor_tables():
    """On CPU tensors the factor tables select nothing: the plain version
    runs, and no kernel launch is counted."""
    blk, y, m, ops, labels, _ = _unfused_case()
    ws = [lin.weight.t() for lin in (blk.attn.to_q, blk.attn.to_k,
                                     blk.attn.to_v)]
    before = wa.fused_window_attention_packed_qkv.launches
    with torch.no_grad():
        want = wa.fused_window_attention_packed_qkv_reference(
            y, *ws, m, ops.bias, labels, 0.5, 2)
        got = wa.fused_window_attention_packed_qkv(
            y, *ws, m, ops.bias, labels, 0.5, 2, factors=ops.factors)
        apart = wa.fused_window_attention_packed_qkv_prompts(
            y[:, :, :m], y[0, 0, m:], *ws, ops.bias, labels, 0.5, 2,
            factors=ops.factors)
        q = y[:, :, :m].contiguous()
        got7 = wa.fused_window_attention_packed(
            q, y, y, ops.bias, labels, 0.5, 2, factors=ops.factors)
        want7 = wa.fused_window_attention_packed_reference(
            q, y, y, ops.bias, labels, 0.5, 2)
    assert torch.equal(got, want) and torch.equal(apart, want)
    assert torch.equal(got7, want7)
    assert wa.fused_window_attention_packed_qkv.launches == before
    with pytest.raises(ValueError, match="y_prompt"):
        wa.fused_window_attention_packed_qkv_prompts(
            y[:, :, :m], y[0, 0, m:, :8], *(torch.zeros(16, 16),) * 3,
            ops.bias, labels, 0.5, 2)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prompt_rows_apart_equal_the_whole_windows(use_kernels, monkeypatch):
    """The unfused block's attention call (content rows and the shared
    prompt rows apart, ``forward_prompts``) equals the JAX-signature call
    on the whole windows, and the block's forward makes it."""
    blk, y, m, ops, labels, (x, tok) = _unfused_case(7)
    blk.attn.use_kernels = use_kernels
    with torch.no_grad():
        whole = blk.attn(y, y, y, ops.bias, labels, q_rows=m,
                         factors=ops.factors)
        apart = blk.attn.forward_prompts(y[:, :, :m], y[0, 0, m:],
                                         ops.bias, labels,
                                         factors=ops.factors)
        calls = []
        monkeypatch.setattr(wa, "fused_window_attention_packed_qkv_prompts",
                            lambda *a, **k: calls.append(a[1]) or
                            wa.fused_window_attention_packed_qkv(
                                torch.cat([a[0], a[1].expand(
                                    *a[0].shape[:2], -1, -1)], 2),
                                *a[2:5], a[0].shape[2], *a[5:], **k))
        blk(x, tok)
    assert apart.shape == (*y.shape[:2], m, 16)
    assert torch.equal(apart, whole)
    assert len(calls) == use_kernels
    if use_kernels:
        assert torch.equal(calls[0], y[0, 0, m:])
