"""PyTorch port: the fused Swin block in training -- counter-hash dropout
and gradients -- against the JAX package.

* ``hash_u32``/``keep_mask`` are bit-exact against ``ops/prng.py``,
  including counters past 2^31 and the wrap of the uint32 multiply.
* The attention-dropout mask the port builds for its key layout (content,
  fold, prompt) equals, bit for bit, the JAX kernel's mask over its own
  layout (content, fold, alignment columns, prompt) with the alignment
  columns dropped: the counter stride is the JAX key count ``n_jax``.
* The block forward with dropout 0.1/0.1 against ``_block_reference`` and
  the interpret-mode TPU kernel: 3e-2 and 4e-2 absolute on O(1) outputs,
  the bounds of tests/test_torch_fused_block.py (bf16 rounding of matmul
  outputs; a mask that differed would move outputs by O(0.1)).
* Gradients (x, tokens, every parameter, bias) of the port's autograd
  Function on the CPU against ``jax.vjp`` of ``_block_reference``, dropout
  on: 3e-2 of each gradient's largest magnitude.  Both sides round the
  matmul operands (and JAX its cotangents) to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu.ops import \
    fused_block as jax_fb
from medical_image_segmentation_with_visual_prompts_tpu.ops import \
    prng as jax_prng
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block as fb
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    prng

B, P, M, C, H = 2, 4, 16, 16, 2
N_TOK = 3
SCALE = (C // H) ** -0.5
SEEDS = (123456789, 0xDEADBEEF)
DROP = fb.Dropout(SEEDS, 0.1, 0.1)

CASES = [
    # (fold_mode, shifted, with tokens)
    (fb.FOLD_NONE, False, False),
    (fb.FOLD_NONE, True, True),
    (fb.FOLD_KEY, False, True),
    (fb.FOLD_COUNT, True, True),
    (fb.FOLD_COUNT, True, False),
]


def test_hash_and_keep_mask_are_bit_exact():
    rng = np.random.default_rng(0)
    idx = np.concatenate([
        np.arange(0, 4096), rng.integers(0, 2 ** 32, 4096),
        np.array([2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, 2 ** 32 - 1]),
    ]).astype(np.uint32)
    for seed in (0, 1, 2 ** 31 + 5, 2 ** 32 - 1):
        want = np.asarray(jax_prng.hash_u32(jnp.uint32(seed),
                                            jnp.asarray(idx)))
        got = prng.hash_u32(seed, torch.from_numpy(idx.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        for rate in (0.1, 0.25, 0.5):
            km = np.asarray(jax_prng.keep_mask(jnp.uint32(seed),
                                               jnp.asarray(idx), rate))
            kt = prng.keep_mask(seed, torch.from_numpy(idx.astype(np.int64)),
                                rate)
            np.testing.assert_array_equal(kt.numpy(), km)
    # Counters computed past 2^32 wrap like the JAX uint32 product.
    big = torch.tensor([2 ** 32 + 7, 3 * 2 ** 32 + 11])
    np.testing.assert_array_equal(
        prng.hash_u32(9, big).numpy(),
        np.asarray(jax_prng.hash_u32(jnp.uint32(9),
                                     jnp.asarray([7, 11], jnp.uint32))))


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
    n = M + (1 if fold_mode else 0) + (N_TOK if with_tokens else 0)
    bias = rng.standard_normal((H, M, n)).astype(f32)
    labels = None
    if shifted:
        labels = np.concatenate(
            [rng.integers(0, 3, (P, M)), np.full((P, n - M), -1)],
            axis=1).astype(np.int32)
    x = rng.standard_normal((B, P, M, C)).astype(f32)
    return x, params, tokens, bias, labels


def _jax_operands(bias, labels, fold_mode, n_tok):
    """The JAX layout: ``fold_width - 1`` alignment columns (bias -1e30,
    label -1) after the fold column; returns them and the n_fold."""
    if not fold_mode:
        return bias, labels, 0
    nf = jax_fb.fold_width(M, n_tok)
    bias = np.concatenate([bias[:, :, :M + 1],
                           np.full((H, M, nf - 1), -1e30, np.float32),
                           bias[:, :, M + 1:]], axis=-1)
    if labels is not None:
        labels = np.concatenate([labels[:, :M + 1],
                                 np.full((P, nf - 1), -1, np.int32),
                                 labels[:, M + 1:]], axis=-1)
    return bias, labels, nf


def _port_ops(params, tokens, bias, fold_mode, requires_grad=False):
    t = {k: torch.from_numpy(v.copy()).requires_grad_(requires_grad)
         for k, v in params.items()}
    tok = None if tokens is None else \
        torch.from_numpy(tokens.copy()).requires_grad_(requires_grad)
    b = torch.from_numpy(bias.copy()).requires_grad_(requires_grad)
    return fb.make_operands(t, tok, b, fold_mode, H, SCALE), t, tok, b


@pytest.mark.parametrize("fold_mode", [fb.FOLD_NONE, fb.FOLD_KEY])
def test_attention_mask_matches_the_jax_layout(fold_mode):
    n_tok = N_TOK
    n = M + (1 if fold_mode else 0) + n_tok
    nf = jax_fb.fold_width(M, n_tok) if fold_mode else 0
    n_jax = M + nf + n_tok
    drop_cols = n + (nf - 1 if fold_mode else 0)
    assert drop_cols == n_jax
    if fold_mode:
        assert n_jax != n           # 24 keys in JAX, 20 here
    got = fb.attn_keep(DROP, B * P, H, M, n, drop_cols, "cpu").numpy()
    w = np.arange(B * P, dtype=np.uint32)[:, None, None, None]
    hh = np.arange(H, dtype=np.uint32)[None, :, None, None]
    rr = np.arange(M, dtype=np.uint32)[None, None, :, None]
    jj = np.arange(n_jax, dtype=np.uint32)[None, None, None, :]
    idx = ((w * H + hh) * M + rr) * n_jax + jj
    want = np.asarray(jax_prng.keep_mask(jnp.uint32(SEEDS[0]),
                                         jnp.asarray(idx), 0.1))
    if fold_mode:       # drop the alignment columns
        want = np.concatenate([want[..., :M + 1], want[..., M + nf:]], -1)
    np.testing.assert_array_equal(got, want)
    assert 0.05 < (got == 0).mean() < 0.15


@pytest.mark.parametrize("fold_mode,shifted,with_tokens", CASES)
def test_dropout_forward_matches_jax(fold_mode, shifted, with_tokens):
    x, params, tokens, bias, labels = _case(fold_mode, shifted, with_tokens)
    ops, *_ = _port_ops(params, tokens, bias, fold_mode)
    lab = None if labels is None else torch.from_numpy(labels)
    with torch.inference_mode():
        got = fb.fused_swin_block(torch.from_numpy(x), ops, lab,
                                  DROP).numpy()
        undropped = fb.fused_swin_block(torch.from_numpy(x), ops,
                                        lab).numpy()
    n_tok = N_TOK if with_tokens else 0
    jbias, jlab, nf = _jax_operands(bias, labels, fold_mode, n_tok)
    seeds = jnp.asarray(SEEDS, jnp.uint32)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jtok = None if tokens is None else jnp.asarray(tokens)
    want = jax_fb._block_reference(
        jnp.asarray(x.reshape(B * P, M, C)), jtok, jparams,
        jnp.asarray(jbias), None if jlab is None else jnp.asarray(jlab),
        SCALE, H, fold_mode=fold_mode, n_fold=max(nf, 1), seeds=seeds,
        attn_drop=0.1, proj_drop=0.1)
    np.testing.assert_allclose(got.reshape(B * P, M, C), np.asarray(want),
                               atol=3e-2, rtol=0)
    assert np.abs(got - undropped).max() > 0.3    # dropout is on
    kern = jax_fb.fused_swin_block(
        jnp.asarray(x), jtok, jparams, jnp.asarray(jbias)[None, None], jlab,
        SCALE, H, fold_mode=fold_mode, dropout_seeds=seeds, attn_drop=0.1,
        proj_drop=0.1, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), atol=4e-2, rtol=0)


@pytest.mark.parametrize("fold_mode,shifted,with_tokens", CASES)
def test_gradients_match_jax_vjp(fold_mode, shifted, with_tokens):
    x, params, tokens, bias, labels = _case(fold_mode, shifted, with_tokens,
                                            seed=2)
    ops, tp, ttok, tb = _port_ops(params, tokens, bias, fold_mode, True)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    dout = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)
    lab = None if labels is None else torch.from_numpy(labels)
    out = fb.fused_swin_block(xt, ops, lab, DROP)
    out.backward(torch.from_numpy(dout))

    n_tok = N_TOK if with_tokens else 0
    jbias, jlab, nf = _jax_operands(bias, labels, fold_mode, n_tok)
    seeds = jnp.asarray(SEEDS, jnp.uint32)

    def f(xx, tok, prm, bb):
        return jax_fb._block_reference(
            xx, tok, prm, bb, None if jlab is None else jnp.asarray(jlab),
            SCALE, H, fold_mode=fold_mode, n_fold=max(nf, 1), seeds=seeds,
            attn_drop=0.1, proj_drop=0.1)

    primals = (jnp.asarray(x.reshape(B * P, M, C)),
               None if tokens is None else jnp.asarray(tokens),
               {k: jnp.asarray(v) for k, v in params.items()},
               jnp.asarray(jbias))
    _, vjp = jax.vjp(f, *primals)
    gx, gtok, gprm, gbias = vjp(jnp.asarray(dout.reshape(B * P, M, C)))
    gbias = np.asarray(gbias)
    if fold_mode:
        gbias = np.concatenate([gbias[..., :M + 1], gbias[..., M + nf:]], -1)

    def close(name, got, want):
        want = np.asarray(want, np.float32)
        got = got.detach().numpy().reshape(want.shape)
        tol = 3e-2 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol, (name, np.abs(got - want).max(), tol)

    close("x", xt.grad, gx)
    close("bias", tb.grad, gbias)
    if tokens is not None:
        close("tokens", ttok.grad, gtok)
    for k in fb.PARAM_KEYS:
        close(k, tp[k].grad, gprm[k])
