"""PyTorch port: the host side of the block-backward kernel (B4) on the CPU.

The kernel itself runs on the card only (``tests/test_torch_kernels_cuda.py``).
Here: the weight layouts ``make_operands`` builds for it (the (in, out)
weights, k-packed like the forward's, and the concatenated q|k|v weight of
the head sum) against the plain transposes, and the launch plan
(``backward_plan``: cluster size, head groups, row splits, shared bytes) as
a pure function of the shapes.
"""

import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block as fb
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block_bwd as fbb


def _unpack_k16(w):
    """Inverse of ``fused_block.pack_k16`` along the last dim."""
    *lead, k = w.shape
    return w.reshape(*lead, k // 16, 4, 2, 2).transpose(-3, -2).reshape(
        *lead, k)


def _ops(c, heads, m=32, n_tok=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    params = {k: r(c, c) / c ** 0.5 for k in ("wq", "wk", "wv", "wproj",
                                               "wmlp")}
    params.update({k: r(c) for k in ("ln1_scale", "ln1_bias", "bproj",
                                     "ln2_scale", "ln2_bias", "bmlp")})
    bias = r(heads, m, m + 1 + n_tok)
    ops = fb.make_operands(params, r(n_tok, c), bias, fb.FOLD_KEY, heads,
                           (c // heads) ** -0.5, torch.bfloat16)
    return params, ops


@pytest.mark.parametrize("c,heads", [(16, 2), (48, 4), (96, 8), (192, 4)])
def test_backward_layouts_are_the_weights_in_out(c, heads):
    """wproj_io_kp and wmlp_io_kp hold the bf16 (in, out) weights, and
    wqkv_io_kp [C, 3C] holds Wq | Wk | Wv, so its columns of head h are
    the per-head (in, out) q/k/v slices; the forward's k-packed
    weights are the (out, in) transposes."""
    params, ops = _ops(c, heads)
    k = fb._kernel_layout(ops)
    bf = torch.bfloat16
    assert torch.equal(_unpack_k16(k["wproj_io_kp"]), params["wproj"].to(bf))
    assert torch.equal(_unpack_k16(k["wmlp_io_kp"]), params["wmlp"].to(bf))
    assert torch.equal(_unpack_k16(k["wproj_kp"]),
                       params["wproj"].t().to(bf))
    assert torch.equal(_unpack_k16(k["wmlp_kp"]), params["wmlp"].t().to(bf))
    cat = _unpack_k16(k["wqkv_io_kp"])
    assert cat.shape == (c, 3 * c) and cat.dtype == bf
    dh = c // heads
    for which, key in enumerate(("wq", "wk", "wv")):
        for h in range(heads):
            cols = slice(which * c + h * dh, which * c + (h + 1) * dh)
            assert torch.equal(cat[:, cols],
                               params[key][:, h * dh:(h + 1) * dh].to(bf))
    # The forward's per-head layout is the same weights transposed.
    qkv = _unpack_k16(k["wqkv_kp"])
    for which, key in enumerate(("wq", "wk", "wv")):
        for h in range(heads):
            assert torch.equal(qkv[h, which, :dh],
                               params[key][:, h * dh:(h + 1) * dh].t().to(bf))


def test_pack_k16_round_trip():
    w = torch.randn(3, 5, 64)
    assert torch.equal(_unpack_k16(fb.pack_k16(w)), w)


# (name, M, N, C, heads, table floats, windows at batch 2, (ks, hs, qs,
# threads) the plan picks on a 132-SM card)
FLAGSHIP = [
    ("enc0", 256, 320, 48, 4, 64 + 64 + 16 + 64, 128, (2, 2, 1, 512)),
    ("enc1", 128, 193, 96, 8, 64 + 64 + 16 + 65 + 128, 32, (2, 2, 1, 512)),
    ("enc2", 128, 193, 192, 16, 64 + 64 + 16 + 65 + 128, 8, (8, 8, 1, 256)),
    ("dec0", 128, 193, 192, 4, 64 + 64 + 16 + 65 + 128, 8, (8, 4, 2, 256)),
    ("dec1", 128, 193, 96, 4, 64 + 64 + 16 + 65 + 128, 32, (2, 2, 1, 256)),
]


@pytest.mark.parametrize("name,m,n,c,heads,tabw,bp,want", FLAGSHIP)
def test_backward_plan_flagship(name, m, n, c, heads, tabw, bp, want):
    plan = fbb.backward_plan(bp, m, n, c, heads, tabw, sms=132)
    assert (plan.ks, plan.hs, plan.qs, plan.threads) == want, plan
    assert plan.hs * plan.qs == plan.ks and heads % plan.hs == 0
    assert plan.smem == fbb.backward_smem(m, n, c, heads, tabw, plan.ks)
    assert plan.smem <= fbb.SMEM_PER_CTA and plan.ctas_per_sm >= 1
    # At least 64 CTAs per call, where the 8-window calls had 8.
    assert bp * plan.ks >= 64


@pytest.mark.parametrize("name,m,n,c,heads,tabw,bp,want", FLAGSHIP)
def test_backward_plan_is_a_function_of_the_shapes(name, m, n, c, heads,
                                                   tabw, bp, want):
    """Same shapes, same plan; a grid that fills the card keeps the
    fewest CTAs per window that reach the most CTAs per SM; more SMs
    never pick fewer CTAs per window."""
    plans = [fbb.backward_plan(bp, m, n, c, heads, tabw, sms=s)
             for s in (16, 132, 1024)]
    assert fbb.backward_plan(bp, m, n, c, heads, tabw, sms=132) == plans[1]
    assert plans[0].ks <= plans[1].ks <= plans[2].ks
    best = max(fbb.backward_plan(bp, m, n, c, heads, tabw, cluster=ks
                                 ).ctas_per_sm
               for ks in (1, 2, 4, 8)
               if fbb.backward_smem(m, n, c, heads, tabw, ks)
               <= fbb.SMEM_PER_CTA)
    big = fbb.backward_plan(10 ** 6, m, n, c, heads, tabw, sms=132)
    assert big.ctas_per_sm == best
    assert all(fbb.backward_plan(10 ** 6, m, n, c, heads, tabw,
                                 cluster=ks).ctas_per_sm < best
               for ks in (1, 2, 4, 8) if ks < big.ks and
               fbb.backward_smem(m, n, c, heads, tabw, ks)
               <= fbb.SMEM_PER_CTA)


@pytest.mark.parametrize("windows", [512, 1024, 13824])
def test_backward_plan_output_layer(windows):
    """The Swin output layer (full/simple + swin layouts): C 48, 4 heads,
    M 256, N 320 -- enc0's shapes at 512 windows per image (1024 at the
    training batch 2).  The shared-memory form fits, at enc0's cluster of
    2 head groups and 512 threads, one CTA per SM."""
    m, n, c, heads, tabw = 256, 320, 48, 4, 64 + 64 + 16 + 64
    plan = fbb.backward_plan(windows, m, n, c, heads, tabw, sms=132)
    assert (plan.big, plan.ks, plan.hs, plan.qs, plan.threads) == \
        (False, 2, 2, 1, 512), plan
    assert plan.smem == fbb.backward_smem(m, n, c, heads, tabw, 2)
    assert plan.smem <= fbb.SMEM_PER_CTA and plan.ctas_per_sm == 1
    assert fbb.backward_smem(m, n, c, heads, tabw, 1) > fbb.SMEM_PER_CTA
    assert plan == fbb.backward_plan(128, m, n, c, heads, tabw, sms=132)


def test_backward_plan_forced_and_refused():
    m, n, c, heads, tabw = 128, 193, 192, 4, 337
    for ks, split in ((4, (4, 1)), (8, (4, 2))):
        plan = fbb.backward_plan(8, m, n, c, heads, tabw, cluster=ks)
        assert (plan.ks, plan.hs, plan.qs) == (ks, *split)
    with pytest.raises(ValueError, match="no cluster of 1 CTAs"):
        fbb.backward_plan(8, m, n, c, heads, tabw, cluster=1)
    # 16 rows or more per CTA: 32 rows take at most 2 CTAs per window.
    with pytest.raises(ValueError):
        fbb.backward_plan(8, 32, 40, 16, 2, 64, cluster=4)
    with pytest.raises(ValueError, match="no cluster size fits"):
        fbb.backward_plan(8, 1024, 1100, 1024, 16, 64)


@pytest.mark.parametrize("m,ks,want", [(256, 1, 256), (256, 2, 128),
                                       (128, 8, 16), (100, 4, 32),
                                       (136, 8, 32)])
def test_row_block(m, ks, want):
    assert fbb.row_block(m, ks) == want


def test_backward_smem_shrinks_with_the_cluster():
    for _, m, n, c, heads, tabw, _, _ in FLAGSHIP:
        sizes = [fbb.backward_smem(m, n, c, heads, tabw, ks)
                 for ks in (1, 2, 4, 8)]
        assert sizes == sorted(sizes, reverse=True), sizes
        assert all(s % 16 == 0 for s in sizes)


@pytest.mark.parametrize("heads,ks,threads", [(16, 8, 512), (4, 8, 256)])
def test_reference_padding_windows_take_the_device_memory_form(heads, ks,
                                                               threads):
    """M 256, N 320 at C 192 (the example config's 16x16x2 stages under
    the reference padding): no cluster size fits the shared-memory layout,
    so the plan is the device-memory form, whose layout holds neither y
    (M x (C + 8) bf16) nor the gathered dqkv rows; the flagship's calls
    keep the shared-memory form."""
    m, n, c, tabw = 256, 320, 192, 64 + 64 + 16 + 64 + 128
    assert all(fbb.backward_smem(m, n, c, heads, tabw, k) > fbb.SMEM_PER_CTA
               for k in (1, 2, 4, 8))
    plan = fbb.backward_plan(8, m, n, c, heads, tabw)
    assert (plan.big, plan.ks, plan.threads) == (True, ks, threads)
    shared = fbb.backward_smem(m, n, c, heads, tabw, ks)
    assert plan.smem == fbb.backward_smem(m, n, c, heads, tabw, ks, True)
    assert shared - plan.smem >= m * (c + 8) * 2
    assert plan.smem <= fbb.SMEM_PER_CTA and plan.smem % 16 == 0
    for _, m2, n2, c2, h2, tabw2, _, _ in FLAGSHIP:
        assert not fbb.backward_plan(8, m2, n2, c2, h2, tabw2).big
    mp = 256
    assert fbb._big_bytes(8, m, c, ks) == 2 * 8 * mp * (ks * (c + 8)
                                                        + 3 * c + 8)


@pytest.mark.parametrize("name,m,n,c,heads,tabw,bp,want", FLAGSHIP)
def test_backward_plan_forced_form(name, m, n, c, heads, tabw, bp, want):
    """``big`` forces the form: at the flagship's calls the device-memory
    form keeps the cluster size and threads of the shared-memory one, in
    less shared memory; the shared-memory form forced where it fits at no
    cluster size is refused."""
    shared = fbb.backward_plan(bp, m, n, c, heads, tabw, big=False)
    big = fbb.backward_plan(bp, m, n, c, heads, tabw, big=True)
    assert shared == fbb.backward_plan(bp, m, n, c, heads, tabw)
    assert (big.big, big.ks, big.hs, big.qs, big.threads) == \
        (True, *want), big
    assert big.smem == fbb.backward_smem(m, n, c, heads, tabw, big.ks, True)
    assert big.smem < shared.smem
    with pytest.raises(ValueError, match="no cluster size fits"):
        fbb.backward_plan(8, 256, 320, 192, 4, 337, big=False)


@pytest.mark.parametrize("m,c,heads,e", [(256, 48, 4, 64), (128, 192, 16, 65),
                                         (100, 96, 8, 0), (33, 16, 1, 3)])
def test_partials_keep_8_byte_stores_aligned(m, c, heads, e):
    n_w, n_c = fbb._part_sizes(m, c, heads, e)
    assert n_w % 4 == 0 and n_c % 2 == 0
    nb = m + e + (m + e) % 2
    assert n_w >= 3 * c * c + 2 * e * c + heads * m * nb > n_w - 4


def test_block_backward_rejects_cpu_tensors():
    _, ops = _ops(16, 2)
    x = torch.randn(1, 1, 32, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fbb.block_backward(x, x, ops, None, fb.NO_DROPOUT)
