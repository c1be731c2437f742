"""PyTorch port: the fused Swin block's plain version against the JAX
package's ``_block_reference`` and its TPU kernel in interpret mode.

Both JAX functions compute with bf16 matmul operands and fp32 sums, as
does ``block_reference(matmul_dtype=bf16)``.  Tolerances:

* vs ``_block_reference``: 3e-2 absolute on O(1) outputs.  The JAX
  reference rounds every matmul OUTPUT to bf16 (bf16 @ bf16 -> bf16),
  the port keeps the projection and MLP outputs in fp32 (as the CUDA
  kernel does): a few bf16 ulps (2^-8 relative) at O(1).
* vs the interpret-mode kernel: 4e-2 (the JAX package's own bound for
  its kernel vs an unfolded reference, tests/test_pad_folding.py): the
  kernel also feeds the probabilities to P.V as bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu.ops import \
    fused_block as jax_fb
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block as fb

B, P, M, C, H = 2, 4, 16, 16, 2
N_TOK = 3
SCALE = (C // H) ** -0.5

CASES = [
    # (fold_mode, shifted, with tokens)
    (fb.FOLD_NONE, False, False),
    (fb.FOLD_NONE, True, True),
    (fb.FOLD_KEY, False, True),
    (fb.FOLD_KEY, False, False),
    (fb.FOLD_COUNT, True, True),
    (fb.FOLD_COUNT, True, False),
]


def _case(fold_mode, shifted, with_tokens, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    params = {
        "ln1_scale": 1 + 0.1 * rng.standard_normal(C),
        "ln1_bias": 0.2 * rng.standard_normal(C),
        "wq": rng.standard_normal((C, C)) / np.sqrt(C),
        "wk": rng.standard_normal((C, C)) / np.sqrt(C),
        "wv": rng.standard_normal((C, C)) / np.sqrt(C),
        "wproj": rng.standard_normal((C, C)) / np.sqrt(C),
        "bproj": 0.1 * rng.standard_normal(C),
        "ln2_scale": 1 + 0.1 * rng.standard_normal(C),
        "ln2_bias": 0.1 * rng.standard_normal(C),
        "wmlp": rng.standard_normal((C, C)) / np.sqrt(C),
        "bmlp": 0.1 * rng.standard_normal(C),
    }
    params = {k: v.astype(f32) for k, v in params.items()}
    tokens = rng.standard_normal((N_TOK, C)).astype(f32) \
        if with_tokens else None
    n_fold = 1 if fold_mode else 0
    i = N_TOK if with_tokens else 0
    n = M + n_fold + i
    bias = rng.standard_normal((H, M, n)).astype(f32)
    labels = None
    if shifted:
        labels = np.concatenate(
            [rng.integers(0, 3, (P, M)), np.full((P, n - M), -1)],
            axis=1).astype(np.int32)
    x = rng.standard_normal((B, P, M, C)).astype(f32)
    return x, params, tokens, bias, labels


def _port(x, params, tokens, bias, labels, fold_mode,
          dtype=torch.bfloat16):
    t = {k: torch.from_numpy(v) for k, v in params.items()}
    ops = fb.make_operands(t, None if tokens is None
                           else torch.from_numpy(tokens),
                           torch.from_numpy(bias), fold_mode, H, SCALE, dtype)
    lab = None if labels is None else torch.from_numpy(labels)
    with torch.inference_mode():
        return fb.fused_swin_block(torch.from_numpy(x), ops, lab).numpy()


@pytest.mark.parametrize("fold_mode,shifted,with_tokens", CASES)
def test_block_reference_matches_jax_reference(fold_mode, shifted,
                                               with_tokens):
    x, params, tokens, bias, labels = _case(fold_mode, shifted, with_tokens)
    got = _port(x, params, tokens, bias, labels, fold_mode)
    want = jax_fb._block_reference(
        jnp.asarray(x.reshape(B * P, M, C)),
        None if tokens is None else jnp.asarray(tokens),
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(bias),
        None if labels is None else jnp.asarray(labels), SCALE, H,
        fold_mode=fold_mode, n_fold=1)
    np.testing.assert_allclose(got.reshape(B * P, M, C), np.asarray(want),
                               atol=3e-2, rtol=0)


def _jax_kernel_operands(bias, labels, fold_mode, n_tok):
    """The TPU kernel pads the fold block with -1e30 alignment columns
    (label -1) up to ``fold_width``: insert them after the fold column."""
    if not fold_mode:
        return bias, labels
    dead = jax_fb.fold_width(M, n_tok) - 1
    bias = np.concatenate([bias[:, :, :M + 1],
                           np.full((H, M, dead), -1e30, np.float32),
                           bias[:, :, M + 1:]], axis=-1)
    if labels is not None:
        labels = np.concatenate([labels[:, :M + 1],
                                 np.full((P, dead), -1, np.int32),
                                 labels[:, M + 1:]], axis=-1)
    return bias, labels


@pytest.mark.parametrize("fold_mode,shifted,with_tokens", CASES)
def test_block_reference_matches_interpret_kernel(fold_mode, shifted,
                                                  with_tokens):
    x, params, tokens, bias, labels = _case(fold_mode, shifted, with_tokens,
                                            seed=1)
    got = _port(x, params, tokens, bias, labels, fold_mode)
    n_tok = N_TOK if with_tokens else 0
    jbias, jlab = _jax_kernel_operands(bias, labels, fold_mode, n_tok)
    want = jax_fb.fused_swin_block(
        jnp.asarray(x), None if tokens is None else jnp.asarray(tokens),
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(jbias)[None, None], jlab, SCALE, H,
        fold_mode=fold_mode, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=4e-2, rtol=0)


def test_fp32_operands_are_exact_math():
    """matmul_dtype fp32 is the unrounded block (parity with the JAX
    model's fp32 XLA path): bf16 moves it by more than float noise."""
    x, params, tokens, bias, labels = _case(fb.FOLD_NONE, True, True)
    a = _port(x, params, tokens, bias, labels, fb.FOLD_NONE, torch.float32)
    b = _port(x, params, tokens, bias, labels, fb.FOLD_NONE)
    assert np.abs(a - b).max() > 1e-4
    np.testing.assert_allclose(a, b, atol=3e-2)


def test_fold_rows_follow_the_fold_mode():
    _, params, tokens, _, _ = _case(fb.FOLD_KEY, False, True)
    t = {k: torch.from_numpy(v) for k, v in params.items()}
    tok = torch.from_numpy(tokens)
    k_key, v_key = fb.extra_kv_rows(t, tok, fb.FOLD_KEY, torch.float32)
    k_cnt, v_cnt = fb.extra_kv_rows(t, tok, fb.FOLD_COUNT, torch.float32)
    torch.testing.assert_close(k_key[0], t["ln1_bias"] @ t["wk"])
    assert not k_cnt[0].any()                        # FOLD_COUNT: k = 0
    torch.testing.assert_close(v_key, v_cnt)         # v = LN1_bias Wv
    assert k_key.shape == (1 + N_TOK, C)
    assert fb.extra_kv_rows(t, None, fb.FOLD_NONE, torch.float32) == \
        (None, None)


def _small_ops():
    x, params, tokens, bias, labels = _case(fb.FOLD_NONE, True, True)
    t = {k: torch.from_numpy(v) for k, v in params.items()}
    ops = fb.make_operands(t, torch.from_numpy(tokens),
                           torch.from_numpy(bias), fb.FOLD_NONE, H, SCALE)
    return torch.from_numpy(x), ops, torch.from_numpy(labels)


def test_wrapper_rejects_bad_calls_before_any_launch():
    x, ops, labels = _small_ops()
    before = fb.fused_swin_block.launches
    with pytest.raises(ValueError, match="x_win has C=8"):
        fb.fused_swin_block(x[..., :8].contiguous(), ops, labels)
    with pytest.raises(ValueError, match="labels must be"):
        fb.fused_swin_block(x, ops, labels[:, :-1])
    with pytest.raises(ValueError, match="bias must be"):
        fb.fused_swin_block(x[:, :, :8].contiguous(), ops, labels)
    # A tensor that requires grad now trains through the block (CPU:
    # the autograd of the plain version), still with no kernel launch.
    xg = x.clone().requires_grad_()
    fb.fused_swin_block(xg, ops, labels).square().sum().backward()
    assert xg.grad is not None and xg.grad.abs().sum() > 0
    assert torch.isfinite(xg.grad).all()
    with pytest.raises(ValueError, match="x_win must be on a CUDA device"):
        fb.check_kernel_args(x.bfloat16(), ops, labels)
    with torch.inference_mode():
        fb.fused_swin_block(x, ops, labels)     # CPU: the plain version
    assert fb.fused_swin_block.launches == before
