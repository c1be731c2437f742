"""PyTorch port: MedSAM's encoder attention core (``ops/sam_attention.py``)
on the CPU, where the wrapper takes its plain version, against
segment_anything's attention with ``add_decomposed_rel_pos``: the bias
materialised as an ``[N, N]`` array, written out here.

Both sides compute in float32 and differ only in the order of their sums
(the plain version folds the bias into widened q and k), a few ulps:
``TOL`` holds it with room.  The kernel itself runs on the card only
(``tests/test_torch_kernels_cuda.py -k sam_attention``).
"""

import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    sam_attention as sa

TOL = 1e-5
HD = 64


def _tables(side, gen):
    """A ``[2 side - 1, hd]`` table (sd as the benchmark's weights draw
    it) and its ``[side, side, hd]`` gather ``R[q - k + side - 1]``."""
    sd = 0.10 if side > 32 else 0.15
    r = sd * torch.randn(2 * side - 1, HD, generator=gen)
    pos = torch.arange(side)
    return r, r[pos[:, None] - pos[None, :] + side - 1].contiguous()


def _materialised(qkv, rel_h, rel_w, heads):
    """segment_anything's image-encoder attention core: scaled scores,
    ``add_decomposed_rel_pos`` on the ``[N, N]`` scores, softmax, PV."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    q, k, v = qkv.reshape(b, h * w, 3, heads, HD).permute(
        2, 0, 3, 1, 4).reshape(3, b * heads, h * w, HD).unbind(0)
    attn = (q * HD ** -0.5) @ k.transpose(-2, -1)
    ih, iw = torch.arange(h), torch.arange(w)
    rh = rel_h[ih[:, None] - ih[None, :] + h - 1]
    rw = rel_w[iw[:, None] - iw[None, :] + w - 1]
    r_q = q.reshape(b * heads, h, w, HD)
    bias_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    bias_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = (attn.view(b * heads, h, w, h, w) + bias_h[:, :, :, :, None]
            + bias_w[:, :, :, None, :]).view(b * heads, h * w, h * w)
    o = attn.softmax(-1) @ v
    return o.view(b, heads, h, w, HD).permute(0, 2, 3, 1, 4).reshape(
        b, h, w, c)


@pytest.mark.parametrize("side,batch,heads,padded", [
    (14, 3, 2, True), (14, 1, 12, False), (16, 1, 2, False),
    (16, 3, 12, False)],
    ids=["window-b3-h2-padded", "window-b1-h12", "global-b1-h2",
         "global-b3-h12"])
def test_plain_path_matches_the_materialised_bias(side, batch, heads, padded):
    gen = torch.Generator().manual_seed(side * 100 + batch * 10 + heads)
    c = heads * HD
    x = torch.randn(batch, side, side, c, generator=gen)
    if padded:
        # The last window of a 70x70 grid cut from 64x64: its last 6 rows
        # and columns are the zero padding, whose qkv is the linear's bias.
        x[-1, 8:] = 0.0
        x[-1, :, 8:] = 0.0
    lin = torch.nn.Linear(c, 3 * c)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(3 * c, c, generator=gen) / c ** 0.5)
        lin.bias.copy_(torch.randn(3 * c, generator=gen))
        qkv = lin(x)
    rel_h, table_h = _tables(side, gen)
    rel_w, table_w = _tables(side, gen)
    before = sa.sam_attention.launches
    with torch.no_grad():
        got = sa.sam_attention(qkv, table_h, table_w, heads)
        want = _materialised(qkv, rel_h, rel_w, heads)
    assert sa.sam_attention.launches == before      # no kernel on the CPU
    assert got.shape == (batch, side, side, c)
    err = (got - want).abs().max().item()
    assert err <= TOL * max(1.0, want.abs().max().item()), err


def _args(h=4, w=4, heads=2, hd=HD, dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, h, w, 3 * heads * hd, generator=gen).to(dtype)
    return (qkv, torch.zeros(h, h, hd, dtype=dtype),
            torch.zeros(w, w, hd, dtype=dtype), heads)


@pytest.mark.parametrize("case,match", [
    (lambda: (torch.zeros(2, 16, 3 * 128),) + _args()[1:], "must be"),
    (lambda: _args()[:3] + (5,), "heads"),
    (lambda: (_args()[0], torch.zeros(4, 4, 32)) + _args()[2:], "table_h"),
    (lambda: (_args()[0][:, :3],) + _args()[1:], "table_h"),
    (lambda: _args(dtype=torch.float16), "float32 or bfloat16"),
    (lambda: (_args()[0], _args()[1].double()) + _args()[2:], "table_h"),
    (lambda: (_args()[0].transpose(1, 2),) + _args()[1:], "contiguous")],
    ids=["three-dims", "heads", "table-width", "table-side", "float16",
         "table-dtype", "strided"])
def test_wrapper_refuses_what_it_does_not_take(case, match):
    with pytest.raises(ValueError, match=match):
        sa.sam_attention(*case())


@pytest.mark.parametrize("h,w,dtype,form", [
    (64, 64, torch.bfloat16, "rows"), (14, 14, torch.bfloat16, "windows"),
    (3, 3, torch.bfloat16, "windows"), (64, 64, torch.float32, "fp32"),
    (20, 20, torch.bfloat16, None), (64, 32, torch.bfloat16, None),
    (80, 80, torch.float32, None)])
def test_kernel_form_follows_the_grid(h, w, dtype, form):
    qkv = torch.zeros(1, h, w, 3 * 2 * HD, dtype=dtype)
    if form is None:
        with pytest.raises(ValueError, match="takes"):
            sa.kernel_form(qkv, 2)
    else:
        assert sa.kernel_form(qkv, 2) == form


@pytest.mark.parametrize("hd,grad", [(32, False), (HD, True)],
                         ids=["head-size", "requires-grad"])
def test_kernel_refuses_other_head_sizes_and_gradients(hd, grad):
    qkv = torch.zeros(1, 14, 14, 3 * 2 * hd, requires_grad=grad)
    with pytest.raises(ValueError, match="head size|grad"):
        sa.kernel_form(qkv, 2)


def test_smoke_bound_counts_the_benchmarks_work():
    """``chip_smoke.py`` times the kernel beside the work the benchmark's
    ``encoder_attention_roofline.sam`` divides by: the same count for the
    global and the windowed call of a 16-slice batch."""
    import chip_smoke
    from benchmark import arith_medsam
    from medical_image_segmentation_with_visual_prompts_tpu_torch.reference \
        import medsam as ref
    work = arith_medsam.attention_work(dict(ref.VIT_B,
                                            compute_dtype="bfloat16"), 16, 16)
    glob = ref.VIT_B["encoder_global_attn_indexes"]
    assert 0 not in glob                 # block 0 attends in windows
    assert chip_smoke.sam_attention_work(16, 64, 64) == work[glob[0]]
    assert chip_smoke.sam_attention_work(400, 14, 14) == work[0]
