"""PyTorch port: the attention bias that the forward kernels B1 and B5
build from its factors.

The kernels read the content bias as three per-axis tables and each
row's window coordinate, then the fold column and the prompt-token
columns (``ops/fused_block.py::bias_tables``), in place of the assembled
``[H, M, N]`` array that the plain version, the backward kernel and
autograd take.  ``table_bias`` evaluates those operands with the
kernel's indexing and order of operations; here it must give
``BlockOperands.bias`` bit for bit, on the flagship's six block
geometries (shifted and not, 64 prompt tokens), pad-folded geometries
with the logsumexp (unshifted) and ``ln(n_pad)`` (shifted) fold column,
without prompt tokens, and under ``pad_mode: reference``.  Only the
bias is built, so full-size geometries run on the CPU.

The bias itself is held against the JAX package's by the block and
model parity tests (tests/test_torch_modules.py,
tests/test_torch_swin_unetr.py).
"""

import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinTransformerBlock
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block as fb
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    init_weights

FLAGSHIP = [(48, 4, (64, 64, 4)), (96, 8, (32, 32, 2)),
            (192, 16, (16, 16, 2)), (192, 4, (16, 16, 2)),
            (96, 4, (32, 32, 2)), (48, 4, (64, 64, 4))]
SHIFTS = [(0, 0, 0), (4, 4, 2)]

# (C, heads, window, dims, shift, pad_mode, prompt tokens, fold mode)
CASES = [(c, h, (8, 8, 4), dims, shift, "aligned", 64,
          fb.FOLD_NONE if dims[2] == 4 else
          (fb.FOLD_COUNT if any(shift) else fb.FOLD_KEY))
         for c, h, dims in FLAGSHIP for shift in SHIFTS] + [
    (96, 8, (8, 8, 4), (32, 32, 2), (0, 0, 0), "aligned", 0, fb.FOLD_KEY),
    (96, 8, (8, 8, 4), (32, 32, 2), (4, 4, 2), "aligned", 0, fb.FOLD_COUNT),
    (48, 4, (8, 8, 4), (64, 64, 4), (4, 4, 2), "aligned", 0, fb.FOLD_NONE),
    (192, 16, (8, 8, 4), (16, 16, 2), (0, 0, 0), "reference", 0,
     fb.FOLD_NONE),
    (192, 4, (8, 8, 4), (16, 16, 2), (4, 4, 2), "reference", 0,
     fb.FOLD_NONE),
    (16, 2, (4, 4, 4), (8, 12, 2), (2, 2, 1), "aligned", 3, fb.FOLD_COUNT),
    (16, 2, (4, 4, 4), (8, 12, 3), (0, 0, 0), "aligned", 3, fb.FOLD_KEY),
    (16, 2, (4, 4, 4), (8, 6, 3), (2, 2, 1), "reference", 3, fb.FOLD_NONE),
    (8, 2, (2, 4, 4), (6, 8, 4), (1, 2, 2), "aligned", 0, fb.FOLD_NONE),
]


@pytest.mark.parametrize("c,heads,window,dims,shift,pad_mode,n_tok,fold",
                         CASES)
def test_bias_tables_rebuild_block_bias_bit_for_bit(c, heads, window, dims,
                                                   shift, pad_mode, n_tok,
                                                   fold):
    g = torch.Generator().manual_seed(sum(dims) + c + heads + n_tok)
    blk = SwinTransformerBlock(c, window, 64, heads, 1, max(n_tok, 1),
                               shift_size=shift, pad_mode=pad_mode)
    blk = init_weights(blk, g).eval()
    tokens = torch.randn((n_tok, c), generator=g) if n_tok else None
    with torch.no_grad():
        x = torch.zeros((1, *dims, c))
        _, _, ops, _, _ = blk.operands(x, tokens)
        assert ops.fold_mode == fold
        h, m, n = ops.bias.shape
        assert ops.n_ext == n - m == n_tok + (1 if fold else 0)
        pe_tab, pe_coord = fb.bias_tables(ops, ops.bias)
        got = fb.table_bias(pe_tab, pe_coord, ops.factors.dims, m, n,
                            bool(fold), ops.factors.scale)
    assert pe_coord.dtype == torch.int32 and pe_coord.shape == (m,)
    assert got.shape == ops.bias.shape
    assert torch.equal(got, ops.bias)
    # The flag that lets keys j and j + 1 share R + Cw: set exactly where
    # row j + 1 is one step deeper in the window than row j.
    coords = ops.factors.coords()
    deeper = (coords[1:] - coords[:-1] == torch.tensor([0, 0, 1])).all(-1)
    flags = (pe_coord.to(torch.int64) >> 24) & 1
    assert torch.equal(flags[:-1].bool(), deeper) and flags[-1] == 0
    if window == (8, 8, 4):
        assert flags[0::2].all()   # the flagship's even keys all pair up


@pytest.mark.parametrize("shape", [(48, 48), (4, 3, 16, 96), (192, 192)])
def test_pack_k16_puts_each_lane_fragment_together(shape):
    """The forward kernels' k-packed weights: lane quad c of an mma
    fragment reads k0 + 2c, k0 + 2c + 1, k0 + 8 + 2c, k0 + 9 + 2c of a row
    as the four values at k0 + 4c of the packed row."""
    w = torch.randn(shape, generator=torch.Generator().manual_seed(7))
    packed = fb.pack_k16(w)
    assert packed.shape == w.shape and packed.is_contiguous()
    for k0 in range(0, shape[-1], 16):
        for c in range(4):
            want = w[..., [k0 + 2 * c, k0 + 2 * c + 1, k0 + 8 + 2 * c,
                           k0 + 9 + 2 * c]]
            assert torch.equal(packed[..., k0 + 4 * c:k0 + 4 * c + 4], want)
