"""PyTorch port: the decoder convs' plain versions against the JAX
package's ``conv3x3_fused_pair`` (B2) and ``conv3x3_fused`` (B3, its
one-input form with optional affine and LeakyReLU) TPU kernels in
interpret mode.

Both sides round xa/xb, the prologue output and the weights to bf16 and
sum in fp32.  The TPU kernel also computes the BN affine itself in bf16
(scale and shift rounded to bf16, ``conv_pallas.py:303``), the port in
fp32, so the bound is 1% of the largest output (~2.5 bf16 ulps there;
the JAX package holds the same kernel to 2-4e-2 in
tests/test_conv_pallas.py).  Port-only checks are fp32 (1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from medical_image_segmentation_with_visual_prompts_tpu.ops.conv_pallas \
    import conv3x3_fused as jax_conv
from medical_image_segmentation_with_visual_prompts_tpu.ops.conv_pallas \
    import conv3x3_fused_pair as jax_conv_pair
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    conv_fused as cf

REL_TOL = 1e-2
ATOL = 1e-5


def _case(shape, ca, cb, co, seed=0, shift_mean=2.0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xa = rng.standard_normal((*shape, ca)).astype(f32)
    xb = rng.standard_normal((*shape, cb)).astype(f32)
    kernel = (rng.standard_normal((3, 3, 3, ca + cb, co))
              / np.sqrt(27 * (ca + cb))).astype(f32)     # HWDIO
    bias = (0.1 * rng.standard_normal(co)).astype(f32)
    scale = (0.5 + rng.random(ca + cb)).astype(f32)
    # A large BN shift: leaky(shift) != 0, so applying the zero padding
    # BEFORE the prologue would change every border voxel.
    shift = (shift_mean + 0.3 * rng.standard_normal(ca + cb)).astype(f32)
    return xa, xb, kernel, bias, scale, shift


def _port(xa, xb, kernel, bias, scale, shift, dtype=torch.bfloat16):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    weight = t(kernel.transpose(4, 3, 0, 1, 2))     # torch [Co, Ci, k, k, k]
    return cf.conv_pair_reference(t(xa), t(xb), weight, t(bias), t(scale),
                                  t(shift), matmul_dtype=dtype,
                                  out_dtype=torch.float32).numpy()


@pytest.mark.parametrize("shape,ca,cb,co", [
    ((2, 6, 5, 4), 8, 4, 6), ((1, 4, 4, 2), 16, 8, 8),
    ((1, 5, 3, 1), 4, 4, 3)])
def test_plain_pair_conv_matches_interpret_kernel(shape, ca, cb, co):
    xa, xb, kernel, bias, scale, shift = _case(shape, ca, cb, co)
    got = _port(xa, xb, kernel, bias, scale, shift)
    want = np.asarray(jax_conv_pair(
        jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(kernel),
        jnp.asarray(bias), jnp.asarray(scale), jnp.asarray(shift),
        leaky=True, out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


def test_padding_comes_after_the_prologue():
    """The case above would catch a prologue-after-padding bug: padding
    the raw input first moves the border voxels far past the bound."""
    xa, xb, kernel, bias, scale, shift = _case((1, 4, 4, 3), 8, 4, 6)
    want = _port(xa, xb, kernel, bias, scale, shift, torch.float32)
    x = torch.from_numpy(np.concatenate([xa, xb], -1)).permute(0, 4, 1, 2, 3)
    x = F.pad(x, (1, 1, 1, 1, 1, 1))                   # pad, THEN prologue
    a = F.leaky_relu(x * torch.from_numpy(scale)[:, None, None, None]
                     + torch.from_numpy(shift)[:, None, None, None], 0.01)
    wrong = F.conv3d(a, torch.from_numpy(np.ascontiguousarray(
        kernel.transpose(4, 3, 0, 1, 2))), torch.from_numpy(bias))
    wrong = wrong.permute(0, 2, 3, 4, 1).numpy()
    assert np.abs(wrong - want).max() > 10 * REL_TOL * np.abs(want).max()
    np.testing.assert_allclose(wrong[:, 1:-1, 1:-1, 1:-1],
                               want[:, 1:-1, 1:-1, 1:-1], atol=ATOL)


def test_wrapper_uses_input_dtype_on_cpu():
    xa, xb, kernel, bias, scale, shift = _case((1, 4, 4, 2), 8, 8, 4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    w = t(kernel.transpose(4, 3, 0, 1, 2))
    before = cf.conv3x3_fused_pair.launches
    out32 = cf.conv3x3_fused_pair(t(xa), t(xb), w, t(bias), t(scale),
                                  t(shift))
    want32 = F.conv3d(F.leaky_relu(
        torch.cat([t(xa), t(xb)], -1) * t(scale) + t(shift), 0.01).permute(
            0, 4, 1, 2, 3), w, t(bias), padding=1).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(out32, want32, atol=1e-5, rtol=0)
    out16 = cf.conv3x3_fused_pair(t(xa).bfloat16(), t(xb).bfloat16(), w,
                                  t(bias), t(scale), t(shift))
    assert out16.dtype == torch.bfloat16
    assert cf.conv3x3_fused_pair.launches == before


def test_wrapper_rejects_bad_calls_before_any_launch():
    xa, xb, kernel, bias, scale, shift = _case((1, 4, 4, 2), 8, 8, 4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    w = t(kernel.transpose(4, 3, 0, 1, 2))
    args = [t(xa), t(xb), w, t(bias), t(scale), t(shift)]
    with pytest.raises(ValueError, match="weight must be"):
        cf.conv3x3_fused_pair(*args[:2], w[:, :8].contiguous(), *args[3:])
    with pytest.raises(ValueError, match="xa and xb must be"):
        cf.conv3x3_fused_pair(args[0], args[1][:, :2].contiguous(),
                              *args[2:])
    with pytest.raises(ValueError, match="shift must be"):
        cf.conv3x3_fused_pair(*args[:5], args[5][:3])
    with pytest.raises(ValueError, match="bias must be"):
        cf.conv3x3_fused_pair(*args[:3], args[3][:2], *args[4:])
    with pytest.raises(ValueError, match="require grad"):
        cf.conv3x3_fused_pair(args[0].requires_grad_(), *args[1:])
    with pytest.raises(ValueError, match="xa must be on xa's CUDA device"):
        cf.check_kernel_args(t(xa).bfloat16(), t(xb).bfloat16(),
                             cf.kernel_weight(w), *args[3:])


def test_kernel_weight_layout_is_tap_major():
    """``[Ci / 16, 27, Co, 16]``: per chunk of 16 input channels, the 27
    taps (kh slowest, kd fastest), each output channel's 16 weights; a
    ragged last chunk is zero-padded."""
    # Values below 256 are exact in bf16.
    w = (torch.arange(2 * 40 * 27) % 251).float().reshape(2, 40, 3, 3, 3)
    w27 = cf.kernel_weight(w)
    assert w27.shape == (3, 27, 2, 16) and w27.dtype == torch.bfloat16
    assert w27.is_contiguous()
    for ci in (0, 17, 39):
        # tap (kh, kw, kd) = (1, 2, 0) -> index 9 + 6 + 0.
        torch.testing.assert_close(w27[ci // 16, 15, :, ci % 16].float(),
                                   w[:, ci, 1, 2, 0])
    full = w27.float().permute(2, 0, 3, 1).reshape(2, 48, 3, 3, 3)
    torch.testing.assert_close(full[:, :40], w)
    assert not full[:, 40:].any()


@pytest.mark.parametrize("shape,ca,cb,co", [((2, 6, 5, 4), 32, 16, 16),
                                            ((1, 5, 9, 2), 16, 16, 32)])
def test_fp32_trunk_kernel_arithmetic_matches_interpret_kernel(shape, ca, cb,
                                                               co):
    """The fp32 trunk on the card: fp32 inputs rounded to bf16 (as the
    wrapper does before the kernel), bf16 matmul operands
    (``kernel_matmul_dtype``), fp32 output, against the JAX pair kernel
    with ``out_dtype=float32`` (which rounds its inputs the same way)."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block import kernel_matmul_dtype
    xa, xb, kernel, bias, scale, shift = _case(shape, ca, cb, co, seed=7)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    dt = kernel_matmul_dtype(torch.float32, "cuda")
    assert dt == torch.bfloat16
    assert kernel_matmul_dtype(torch.float32, "cpu") == torch.float32
    got = cf.conv_pair_reference(
        cf._operand(t(xa)), cf._operand(t(xb)),
        t(kernel.transpose(4, 3, 0, 1, 2)), t(bias), t(scale), t(shift),
        matmul_dtype=dt, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = np.asarray(jax_conv_pair(
        jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(kernel),
        jnp.asarray(bias), jnp.asarray(scale), jnp.asarray(shift),
        leaky=True, out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


@pytest.mark.parametrize("affine,leaky", [(True, True), (True, False),
                                          (False, True), (False, False)])
@pytest.mark.parametrize("shape,ci,co", [((2, 6, 5, 4), 12, 6),
                                         ((1, 4, 4, 2), 16, 16)])
def test_plain_conv_matches_interpret_kernel(shape, ci, co, affine, leaky):
    x, _, kernel, bias, scale, shift = _case(shape, ci, 0, co, seed=4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = cf.conv_reference(
        t(x), t(kernel.transpose(4, 3, 0, 1, 2)), t(bias),
        t(scale) if affine else None, t(shift) if affine else None, leaky,
        matmul_dtype=torch.bfloat16, out_dtype=torch.float32).numpy()
    want = np.asarray(jax_conv(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
        jnp.asarray(scale) if affine else None,
        jnp.asarray(shift) if affine else None, leaky=leaky,
        out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


def test_one_input_wrapper_on_cpu_is_exact_math_and_launches_nothing():
    x, _, kernel, bias, scale, shift = _case((1, 4, 4, 2), 8, 0, 4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    w = t(kernel.transpose(4, 3, 0, 1, 2))
    before = cf.conv3x3_fused.launches
    for affine, leaky in ((True, True), (False, False), (True, False)):
        a = t(x) * t(scale) + t(shift) if affine else t(x)
        a = F.leaky_relu(a, 0.01) if leaky else a
        want = F.conv3d(a.permute(0, 4, 1, 2, 3), w, t(bias),
                        padding=1).permute(0, 2, 3, 4, 1)
        got = cf.conv3x3_fused(t(x), w, t(bias),
                               t(scale) if affine else None,
                               t(shift) if affine else None, leaky)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    # The pair conv is the one-input conv of the concat.
    xa, xb, kernel, bias, scale, shift = _case((1, 4, 4, 2), 8, 4, 6)
    w = t(kernel.transpose(4, 3, 0, 1, 2))
    torch.testing.assert_close(
        cf.conv3x3_fused_pair(t(xa), t(xb), w, t(bias), t(scale), t(shift)),
        cf.conv3x3_fused(torch.cat([t(xa), t(xb)], -1), w, t(bias),
                         t(scale), t(shift), leaky=True), atol=0, rtol=0)
    assert cf.conv3x3_fused.launches == before


def test_one_input_wrapper_rejects_bad_calls():
    x, _, kernel, bias, scale, shift = _case((1, 4, 4, 2), 8, 0, 4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    w = t(kernel.transpose(4, 3, 0, 1, 2))
    with pytest.raises(ValueError, match="weight must be"):
        cf.conv3x3_fused(t(x)[..., :4].contiguous(), w, t(bias))
    with pytest.raises(ValueError, match="together"):
        cf.conv3x3_fused(t(x), w, t(bias), t(scale), None)
    with pytest.raises(ValueError, match="x must be"):
        cf.conv3x3_fused(t(x)[0], w, t(bias))
    with pytest.raises(ValueError, match="conv3x3_fused: xa must be on"):
        cf.check_kernel_args(t(x).bfloat16(), None, cf.kernel_weight(w),
                             t(bias), None, None, "conv3x3_fused")
