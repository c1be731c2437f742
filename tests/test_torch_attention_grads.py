"""PyTorch port: the unfused block's attention in training, against the
JAX package.

* The autograd Functions of B6 (with and without the prompt rows given
  apart), B7 and B8 (``ops/window_attention.py``): gradients against
  ``jax.vjp`` of the JAX public functions with ``interpret=True``, which
  runs their custom VJPs (``_fused_packed_qkv_bwd``, ``_fused_packed_bwd``,
  ``_fused_bwd``), and against autograd of the port's plain versions at
  fp32: within 1e-5 of each gradient's largest magnitude (fp32 both;
  float reassociation).  BP 2, M 16, N 20, C 24 with 2 heads (B8: C 192,
  4 heads), with and without the shift mask.
* The dropout branch (``WindowAttention.attend_dropout``, the JAX XLA
  branch): at rates 0 equal to the JAX ``WindowAttention`` with
  ``attn_impl="xla"`` at ``deterministic=False`` (1e-5); at rate 0.1 the
  masks keep their rate and the seeds decide them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_segmentation_with_visual_prompts_tpu.models \
    .window_attention import WindowAttention as JaxWindowAttention
from medical_image_segmentation_with_visual_prompts_tpu.ops import \
    window_attention_pallas as wap
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    WindowAttention
from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
    .window_attention import dropout, dropout_keep
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    window_attention as wa
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
    .fused_block import Dropout

GRAD_TOL = 1e-5
BP, M, N = 2, 16, 20          # 1 image of 2 windows; 4 key rows past M


def _case(kind: str, masked: bool, seed: int):
    """Inputs of one call: (arrays, labels [P, N] or None, heads, C)."""
    rng = np.random.default_rng(seed)
    c, heads = (192, 4) if kind == "b8" else (24, 2)
    labels = None
    if masked:
        labels = rng.integers(0, 3, (BP, N)).astype(np.int32)
        labels[:, M:] = -1                    # prompt keys never masked
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrays = {"bias": f(heads, M, N)}
    if kind.startswith("b6"):
        arrays.update(y=f(1, BP, N, c),
                      **{w: f(c, c) / np.sqrt(c) for w in ("wq", "wk", "wv")})
    else:
        arrays.update(q=f(1, BP, M, c), k=f(1, BP, N, c), v=f(1, BP, N, c))
    return arrays, labels, heads, c


def _jax_mask(labels):
    if labels is None:
        return None
    mask = (labels[:, :M, None] == labels[:, None, :]) | \
        (labels[:, None, :] < 0)
    return jnp.asarray(mask.astype(np.float32))[None, :, None]


def _port_call(kind, t, labels, heads, c, dt):
    """The port's public function on tensors ``t``; the gradients' inputs
    in the JAX call's order (B6 with prompts: y's gradient is the content
    rows' and the prompt rows' summed over windows, compared apart)."""
    scale = (c // heads) ** -0.5
    lab = None if labels is None else torch.from_numpy(labels)
    if kind == "b6":
        return wa.fused_window_attention_packed_qkv(
            t["y"], t["wq"], t["wk"], t["wv"], M, t["bias"], lab, scale,
            heads, dt)
    if kind == "b6_prompts":
        return wa.fused_window_attention_packed_qkv_prompts(
            t["yc"], t["yp"], t["wq"], t["wk"], t["wv"], t["bias"], lab,
            scale, heads, dt)
    if kind == "b7":
        return wa.fused_window_attention_packed(
            t["q"], t["k"], t["v"], t["bias"], lab, scale, heads, dt)
    split = lambda x: x.view(1, BP, x.shape[2], heads, -1)  # noqa: E731
    return wa.fused_window_attention(split(t["q"]), split(t["k"]),
                                     split(t["v"]), t["bias"], lab, scale,
                                     dt)


def _jax_grads(kind, arrays, labels, heads, c, g):
    scale = (c // heads) ** -0.5
    mask = _jax_mask(labels)
    if kind.startswith("b6"):
        names = ("y", "wq", "wk", "wv", "bias")

        def fn(y, wq, wk, wv, bias):
            return wap.fused_window_attention_packed_qkv(
                y, wq, wk, wv, M, bias[None, None], mask, scale, heads,
                interpret=True)
    elif kind == "b7":
        names = ("q", "k", "v", "bias")

        def fn(q, k, v, bias):
            return wap.fused_window_attention_packed(
                q, k, v, bias[None, None], mask, scale, heads,
                interpret=True)
    else:
        names = ("q", "k", "v", "bias")

        def fn(q, k, v, bias):
            split = lambda x: x.reshape(1, BP, x.shape[2], heads, -1)  # noqa
            return wap.fused_window_attention(
                split(q), split(k), split(v), bias[None, None], mask, scale,
                interpret=True).reshape(1, BP, M, c)
    out, vjp = jax.vjp(fn, *(jnp.asarray(arrays[n]) for n in names))
    return dict(zip(names, (np.asarray(d) for d in vjp(jnp.asarray(g)))))


CASES = [("b6", False), ("b6", True), ("b6_prompts", True), ("b7", False),
         ("b7", True), ("b8", False), ("b8", True)]


@pytest.mark.parametrize("kind,masked", CASES)
def test_function_gradients_match_jax_vjp_and_plain(kind, masked):
    arrays, labels, heads, c = _case(kind, masked, len(kind) + masked)
    if kind == "b6_prompts":      # the prompt rows every window shares
        arrays["y"][:, :, M:] = arrays["y"][:1, :1, M:]
    g = np.random.default_rng(7).standard_normal((1, BP, M, c)).astype(
        np.float32)
    want = _jax_grads(kind, arrays, labels, heads, c, g)
    if kind == "b6_prompts":
        y = arrays["y"]
        want["yc"] = want["y"][:, :, :M]
        want["yp"] = want.pop("y")[:, :, M:].sum((0, 1))
        arrays = dict(arrays, yc=y[:, :, :M], yp=y[0, 0, M:])
        del arrays["y"]
    grads = {}
    for how in ("function", "plain"):
        t = {k: torch.from_numpy(np.array(v)).requires_grad_()
             for k, v in arrays.items()}
        if how == "function":
            out = _port_call(kind, t, labels, heads, c, torch.bfloat16)
        elif kind.startswith("b6"):
            full = t["y"] if kind == "b6" else torch.cat(
                [t["yc"], t["yp"].expand(1, BP, -1, c)], 2)
            out = wa.fused_window_attention_packed_qkv_reference(
                full, t["wq"], t["wk"], t["wv"], M, t["bias"],
                None if labels is None else torch.from_numpy(labels),
                (c // heads) ** -0.5, heads, torch.float32)
        else:
            out = wa.fused_window_attention_packed_reference(
                t["q"], t["k"], t["v"], t["bias"],
                None if labels is None else torch.from_numpy(labels),
                (c // heads) ** -0.5, heads, torch.float32)
        out.reshape(1, BP, M, c).backward(torch.from_numpy(g))
        grads[how] = {k: v.grad.numpy() for k, v in t.items()}
    assert set(grads["function"]) == set(want)
    for name, w in want.items():
        scale = np.abs(w).max()
        assert scale > 0, name
        for how, got in grads.items():
            err = np.abs(got[name] - w).max()
            assert err <= GRAD_TOL * scale, (how, name, err, scale)


def _jax_attention(c, heads):
    return JaxWindowAttention(dim=c, num_heads=heads, attn_drop=0.0,
                              proj_drop=0.0, attn_impl="xla")


def test_dropout_branch_matches_the_jax_xla_branch():
    c, heads, m, n = 24, 2, 16, 20
    rng = np.random.default_rng(3)
    y = rng.standard_normal((2, 3, n, c)).astype(np.float32)
    bias = rng.standard_normal((heads, m, n)).astype(np.float32)
    labels = rng.integers(0, 2, (3, n)).astype(np.int32)
    labels[:, m:] = -1
    mask = (labels[:, :m, None] == labels[:, None, :]) | \
        (labels[:, None, :] < 0)
    jm = _jax_attention(c, heads)
    variables = jm.init(jax.random.PRNGKey(0), y, y, y, bias[None, None],
                        None, q_rows=m)
    want = np.asarray(jm.apply(
        variables, y, y, y, bias[None, None],
        jnp.asarray(mask.astype(np.float32))[None, :, None],
        deterministic=False, q_rows=m,
        rngs={"dropout": jax.random.PRNGKey(1)}))
    p = variables["params"]
    at = WindowAttention(c, heads)
    with torch.no_grad():
        for name in ("to_q", "to_k", "to_v"):
            getattr(at, name).weight.copy_(torch.tensor(
                np.asarray(p[f"{name}_kernel"]).T))
        at.proj.weight.copy_(torch.tensor(np.asarray(p["proj"]["kernel"]).T))
        at.proj.bias.copy_(torch.tensor(np.asarray(p["proj"]["bias"])))
        yt = torch.from_numpy(y)
        off = Dropout((5, 6), 0.0, 0.0)
        got = at.project(at.attend_dropout(
            yt, yt, yt, torch.from_numpy(bias), torch.from_numpy(labels), m,
            off), off)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        # Rate 0.1: the branch runs; the seeds decide the masks.
        drop = Dropout((5, 6), 0.1, 0.1)
        a = at(yt, yt, yt, torch.from_numpy(bias), torch.from_numpy(labels),
               q_rows=m, drop=drop)
        b = at(yt, yt, yt, torch.from_numpy(bias), torch.from_numpy(labels),
               q_rows=m, drop=drop)
        c2 = at(yt, yt, yt, torch.from_numpy(bias),
                torch.from_numpy(labels), q_rows=m,
                drop=Dropout((7, 6), 0.1, 0.1))
        assert torch.equal(a, b) and not torch.equal(a, c2)
    ones = torch.ones(1000, 1000)
    kept = dropout(ones, 0.1, 11)
    assert set(kept.unique().tolist()) == {
        0.0, torch.tensor(1.0 / 0.9).item()}
    assert abs((kept == 0).float().mean().item() - 0.1) < 0.005
    assert torch.equal(dropout_keep((1000, 1000), 0.1, 11, "cpu"), kept > 0)
