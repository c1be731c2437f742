"""PyTorch port: the unfused Swin block path against the JAX package.

* The three window-attention plain versions (B6 ``packed_qkv``, B7
  ``packed``, B8 per-head) against the JAX package's TPU kernels in
  interpret mode, with and without a mask.  Both round q/k/v and P to
  bf16 and sum in fp32; 2e-2 absolute on O(1) outputs, the class the JAX
  suite holds these kernels to (tests/test_bench_ladder.py).
* The labels -> float mask expansion against JAX ``get_attn_mask``.
* ``WindowAttention`` and the unfused ``SwinTransformerBlock`` at fp32
  against the JAX modules' XLA path (1e-4: float reassociation), and the
  block with the kernels' bf16 rounding against the JAX block under
  ``MIVP_NO_FUSED_BLOCK=1`` with interpret-mode kernels (2e-2).
* The tiny downstream SwinUnetR with ``set_fused_block(False)`` on the
  JAX model's exported weights: logits within 1e-4 of the JAX fp32 XLA
  model and of the port's fused path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from medical_image_segmentation_with_visual_prompts_tpu.models import \
    SwinTransformerBlock as JaxBlock
from medical_image_segmentation_with_visual_prompts_tpu.models \
    .window_attention import WindowAttention as JaxWindowAttention
from medical_image_segmentation_with_visual_prompts_tpu.ops import \
    window_attention_pallas as wap
from medical_image_segmentation_with_visual_prompts_tpu.ops import \
    windows as jax_windows
from medical_image_segmentation_with_visual_prompts_tpu.utils.torch_export \
    import export_state_dict
from medical_image_segmentation_with_visual_prompts_tpu.utils.torch_import \
    import _swin_block_rules
from medical_image_segmentation_with_visual_prompts_tpu_torch.config import \
    ModelConfig
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import (
    SwinTransformerBlock, SwinUnetR, WindowAttention)
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    window_attention as wa
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    windows as port_windows

from test_torch_swin_unetr import (VARIANTS, jax_model, port_model,
                                   tiny_conf)

KERNEL_ATOL = 2e-2
FP32_ATOL = 1e-4
B, P, M, N_TOK = 2, 4, 32, 3          # 8 windows of 4x4x2, 3 prompt tokens
N = M + N_TOK


def _labels(rng, masked):
    if not masked:
        return None
    return np.concatenate([rng.integers(0, 3, (P, M)),
                           np.full((P, N_TOK), -1)], 1).astype(np.int32)


def _jax_mask(labels, m=M):
    """The JAX ``[1, P, 1, m, N]`` float mask of the same labels."""
    if labels is None:
        return None
    mask = (labels[:, :m, None] == labels[:, None, :]) | \
        (labels[:, None, :] < 0)
    return jnp.asarray(mask.astype(np.float32))[None, :, None]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


KERNEL_CASES = [(16, 2, False), (16, 2, True), (24, 4, False),
                (24, 4, True)]


@pytest.mark.parametrize("c,heads,masked", KERNEL_CASES)
def test_packed_qkv_plain_matches_interpret_kernel(c, heads, masked):
    rng = np.random.default_rng(c + heads + masked)
    y = rng.standard_normal((B, P, N, c)).astype(np.float32)
    ws = [(rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
          for _ in range(3)]
    bias = rng.standard_normal((heads, M, N)).astype(np.float32)
    labels = _labels(rng, masked)
    scale = (c // heads) ** -0.5
    got = wa.fused_window_attention_packed_qkv(
        _t(y), *map(_t, ws), M, _t(bias), _t(labels), scale, heads).numpy()
    want = wap.fused_window_attention_packed_qkv(
        jnp.asarray(y), *map(jnp.asarray, ws), M,
        jnp.asarray(bias)[None, None], _jax_mask(labels), scale, heads,
        interpret=True)
    assert got.shape == (B, P, M, c)
    np.testing.assert_allclose(got, np.asarray(want), atol=KERNEL_ATOL,
                               rtol=0)


@pytest.mark.parametrize("c,heads,masked", KERNEL_CASES)
def test_packed_plain_matches_interpret_kernel(c, heads, masked):
    rng = np.random.default_rng(10 + c + heads + masked)
    q = rng.standard_normal((B, P, M, c)).astype(np.float32)
    k, v = (rng.standard_normal((B, P, N, c)).astype(np.float32)
            for _ in range(2))
    bias = rng.standard_normal((heads, M, N)).astype(np.float32)
    labels = _labels(rng, masked)
    scale = (c // heads) ** -0.5
    got = wa.fused_window_attention_packed(
        _t(q), _t(k), _t(v), _t(bias), _t(labels), scale, heads).numpy()
    want = wap.fused_window_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(bias)[None, None], _jax_mask(labels), scale, heads,
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=KERNEL_ATOL,
                               rtol=0)


@pytest.mark.parametrize("c,heads,masked", KERNEL_CASES)
def test_per_head_plain_matches_interpret_kernel(c, heads, masked):
    rng = np.random.default_rng(20 + c + heads + masked)
    dh = c // heads
    qh = rng.standard_normal((B, P, M, heads, dh)).astype(np.float32)
    kh, vh = (rng.standard_normal((B, P, N, heads, dh)).astype(np.float32)
              for _ in range(2))
    bias = rng.standard_normal((heads, M, N)).astype(np.float32)
    labels = _labels(rng, masked)
    got = wa.fused_window_attention(
        _t(qh), _t(kh), _t(vh), _t(bias), _t(labels), dh ** -0.5).numpy()
    want = wap.fused_window_attention(
        jnp.asarray(qh), jnp.asarray(kh), jnp.asarray(vh),
        jnp.asarray(bias)[None, None], _jax_mask(labels), dh ** -0.5,
        interpret=True)
    assert got.shape == qh.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=KERNEL_ATOL,
                               rtol=0)


def test_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(5)
    y = _t(rng.standard_normal((B, P, N, 16)).astype(np.float32))
    ws = [_t((rng.standard_normal((16, 16)) / 4).astype(np.float32))
          for _ in range(3)]
    bias = _t(rng.standard_normal((2, M, N)).astype(np.float32))
    labels = _t(_labels(rng, True))
    counters = [wa.fused_window_attention_packed_qkv,
                wa.fused_window_attention_packed, wa.fused_window_attention]
    before = [f.launches for f in counters]
    got = wa.fused_window_attention_packed_qkv(y, *ws, M, bias, labels,
                                               0.3, 2)
    want = wa.fused_window_attention_packed_qkv_reference(
        y, *ws, M, bias, labels, 0.3, 2)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    q = y[:, :, :M].contiguous()
    torch.testing.assert_close(
        wa.fused_window_attention(
            q.view(B, P, M, 2, 8), y.view(B, P, N, 2, 8),
            y.view(B, P, N, 2, 8), bias, labels, 0.3),
        wa.fused_window_attention_packed(q, y, y, bias, labels, 0.3, 2)
        .view(B, P, M, 2, 8), atol=0, rtol=0)
    assert [f.launches for f in counters] == before
    # fp32 rounding is the unrounded math: bf16 moves it.
    exact = wa.fused_window_attention_packed_qkv_reference(
        y, *ws, M, bias, labels, 0.3, 2, torch.float32)
    assert (exact - want).abs().max() > 1e-4


def test_wrappers_reject_bad_calls_before_any_launch():
    rng = np.random.default_rng(6)
    y = _t(rng.standard_normal((B, P, N, 16)).astype(np.float32))
    w = _t(np.eye(16, dtype=np.float32))
    bias = _t(rng.standard_normal((2, M, N)).astype(np.float32))
    labels = _t(_labels(rng, True))
    before = wa.fused_window_attention_packed_qkv.launches
    with pytest.raises(ValueError, match="bias must be"):
        wa.fused_window_attention_packed_qkv(y, w, w, w, M, bias[:, :4],
                                             labels, 1.0, 2)
    with pytest.raises(ValueError, match="labels must be"):
        wa.fused_window_attention_packed_qkv(y, w, w, w, M, bias,
                                             labels[:, :-1], 1.0, 2)
    with pytest.raises(ValueError, match="query rows"):
        wa.fused_window_attention_packed_qkv(y, w, w, w, N + 1, bias,
                                             None, 1.0, 2)
    with pytest.raises(ValueError, match="not a multiple"):
        wa.fused_window_attention_packed(y, y, y, bias, None, 1.0, 3)
    with pytest.raises(ValueError, match="must be on"):
        wa._launch("b7", (y.bfloat16(),), None, None, y.bfloat16(),
                   y.bfloat16(), y.bfloat16(), (B, P, N, N, 16), bias, None,
                   1.0, 2, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 operands"):
        wa._launch("b7", (y,), None, None, y, y, y, (B, P, N, N, 16), bias,
                   None, 1.0, 2, torch.float32)
    assert wa.fused_window_attention_packed_qkv.launches == before


@pytest.mark.parametrize("padded,window,shift,pads", [
    ((8, 8, 4), (4, 4, 2), (2, 2, 1), (0,) * 6),          # tiny, shifted
    ((64, 64, 4), (8, 8, 4), (4, 4, 2), (0,) * 6),        # enc0 / dec2
    ((32, 32, 4), (8, 8, 4), (4, 4, 0), (0, 0, 0, 0, 1, 1)),  # enc1, padded
    ((16, 16, 4), (8, 8, 4), (4, 4, 0), (0, 0, 0, 0, 1, 1)),  # enc2, padded
])
def test_label_mask_is_the_jax_attention_mask(padded, window, shift, pads):
    n_tok = 64 if window == (8, 8, 4) else N_TOK
    want_np = jax_windows.get_attn_mask(padded, window, shift, pads)
    np.testing.assert_array_equal(
        port_windows.get_attn_mask(padded, window, shift, pads), want_np)
    p, n, _ = want_np.shape
    total = np.zeros((p, n + n_tok, n + n_tok), np.float32)
    total[:, :n, :n] = want_np
    total[:, :n, n:] = 1.0         # prompt keys never masked
    labels = np.concatenate(
        [port_windows.get_attn_labels(padded, window, shift, pads),
         np.full((p, n_tok), -1, np.int32)], 1)
    got = wa.label_mask(torch.from_numpy(labels), n).numpy()
    np.testing.assert_array_equal(got, total[:, :n])


def _jax_block(impl, c=8, heads=2):
    return JaxBlock(hidden_channels=c, window_size=(4, 4, 4),
                    pos_bias_embed_dim=8, num_heads=heads, max_prompts=1,
                    tokens_per_prompt=3, use_token_params=True,
                    shift_size=(2, 2, 2), attn_impl=impl, pad_mode="aligned")


def _port_block(variables, c=8, heads=2):
    """The port's unfused block on the JAX block's parameters (the
    reference key rules of ``torch_import``)."""
    flat = traverse_util.flatten_dict({"params": {"b": variables["params"]}},
                                      sep="/")
    sd = {}
    for key, rule in _swin_block_rules("b", "b", 1).items():
        if rule is None:
            continue
        coll, path, fn = rule
        a = np.asarray(flat[f"{coll}/{path}"])
        sd[key[2:]] = torch.from_numpy(np.array(
            a[fn[1]] if isinstance(fn, tuple) else fn(a)))
    blk = SwinTransformerBlock(c, (4, 4, 4), 8, heads, 1, 3,
                               shift_size=(2, 2, 2), pad_mode="aligned")
    blk.load_state_dict(sd, strict=True)
    blk.fused_block = False
    return blk.eval()


@pytest.fixture(scope="module", params=[(2, 8, 8, 4, 8), (2, 8, 8, 2, 8)],
                ids=["masked_shift", "fold_eligible_depth"])
def block_pair(request):
    shape = request.param
    x = jax.random.normal(jax.random.PRNGKey(0), shape)
    p = jnp.broadcast_to(
        jax.random.normal(jax.random.PRNGKey(1), (1, 3, shape[-1])),
        (shape[0], 3, shape[-1]))
    ref = _jax_block("xla")
    variables = ref.init(jax.random.PRNGKey(2), x, p)
    want = np.asarray(ref.apply(variables, x, p))
    return x, p, variables, want


def test_unfused_block_matches_jax_xla_fp32(block_pair):
    x, p, variables, want = block_pair
    blk = _port_block(variables)
    xt, tok = _t(np.asarray(x)), _t(np.asarray(p[0]))
    with torch.inference_mode():
        got = blk(xt, tok).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
    # The port's own fused block (pad-folded at depth 2) on the same
    # weights computes the same function.
    blk.fused_block = True
    with torch.inference_mode():
        fused = blk(xt, tok).numpy()
    np.testing.assert_allclose(fused, got, atol=FP32_ATOL, rtol=0)


def test_unfused_block_matches_jax_interpret_kernels(block_pair,
                                                     monkeypatch):
    x, p, variables, _ = block_pair
    monkeypatch.setenv("MIVP_NO_FUSED_BLOCK", "1")
    monkeypatch.setattr(wap, "_FORCE_INTERPRET", True)
    want = np.asarray(_jax_block("auto").apply(variables, x, p))
    blk = _port_block(variables)
    blk.attn.matmul_dtype = torch.bfloat16     # the kernels' rounding
    xt, tok = _t(np.asarray(x)), _t(np.asarray(p[0]))
    with torch.inference_mode():
        got = blk(xt, tok).numpy()
    np.testing.assert_allclose(got, want, atol=KERNEL_ATOL, rtol=0)


@pytest.mark.parametrize("c,heads,same_qkv", [(8, 2, True), (8, 2, False),
                                              (144, 12, True)])
def test_window_attention_matches_jax_xla_fp32(c, heads, same_qkv):
    """The three dispatches (B6, B7, B8) of ``WindowAttention.forward``
    against the JAX module's XLA path, shifted mask and prompt rows."""
    rng = np.random.default_rng(c + same_qkv)
    m, n_tok, pw = 16, 3, 2
    n = m + n_tok
    y = rng.standard_normal((1, pw, n, c)).astype(np.float32)
    bias = rng.standard_normal((heads, m, n)).astype(np.float32)
    labels = np.concatenate([rng.integers(0, 2, (pw, m)),
                             np.full((pw, n_tok), -1)], 1).astype(np.int32)
    jm = JaxWindowAttention(dim=c, num_heads=heads, attn_impl="xla")
    yj = jnp.asarray(y)
    qj = yj if same_qkv else yj[:, :, :m] * 0.5
    mask = _jax_mask(labels, m)
    q_rows = m if same_qkv else None
    variables = jm.init(jax.random.PRNGKey(0), qj, yj, yj,
                        jnp.asarray(bias)[None, None], mask, q_rows=q_rows)
    want = np.asarray(jm.apply(variables, qj, yj, yj,
                               jnp.asarray(bias)[None, None], mask,
                               q_rows=q_rows))
    prm = variables["params"]
    port = WindowAttention(c, heads)
    port.load_state_dict({
        "to_q.weight": _t(np.asarray(prm["to_q_kernel"]).T),
        "to_k.weight": _t(np.asarray(prm["to_k_kernel"]).T),
        "to_v.weight": _t(np.asarray(prm["to_v_kernel"]).T),
        "proj.weight": _t(np.asarray(prm["proj"]["kernel"]).T),
        "proj.bias": _t(np.asarray(prm["proj"]["bias"]))}, strict=True)
    yt = _t(y)
    qt = yt if same_qkv else _t(np.asarray(qj))
    with torch.inference_mode():
        got = port(qt, yt, yt, _t(bias), _t(labels), q_rows=m).numpy()
    assert got.shape == want.shape == (1, pw, m, c)
    np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)


@pytest.fixture(scope="module", params=["tiny_aligned", "fold_aligned"])
def model_pair(request):
    conf = tiny_conf(**VARIANTS[request.param])
    jm, jconf, variables = jax_model(conf)
    x = np.random.default_rng(3).standard_normal(
        (2, *conf["roi_size"], 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(
        v, x, deterministic=True)["downstream"])(variables, jnp.asarray(x)))
    return conf, export_state_dict(variables, jconf), x, want


def test_unfused_model_matches_jax_and_the_fused_path(model_pair):
    conf, sd, x, want = model_pair
    model = port_model(conf, sd).set_fused_block(False)  # strict load
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        kinds = {key[0] for m in model.modules() if hasattr(m, "_cache")
                 for key in m._cache}
        fused = model.set_fused_block(True)(torch.from_numpy(x)).numpy()
    assert kinds == {"unfused"}                # no pad folding, no B1
    np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(got, fused, atol=FP32_ATOL, rtol=0)


def test_fused_block_switch_is_read_once_at_build(monkeypatch):
    mc = ModelConfig.from_mapping(tiny_conf())

    def flags(model):
        return {m.fused_block for m in model.modules()
                if hasattr(m, "fused_block")}

    monkeypatch.setenv("MIVP_NO_FUSED_BLOCK", "1")
    model = SwinUnetR(mc)
    assert flags(model) == {False}
    monkeypatch.setenv("MIVP_NO_FUSED_BLOCK", "0")
    assert flags(model) == {False}            # read at build only
    assert flags(SwinUnetR(mc)) == {True}
    monkeypatch.delenv("MIVP_NO_FUSED_BLOCK")
    assert flags(SwinUnetR(mc).set_fused_block(False)) == {False}


def test_unfused_block_refuses_dropout_in_training():
    """The unfused block trains with dropout, its seeds drawn from the
    block's generator: without one it refuses; with one it runs, and two
    calls draw different masks."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import init_weights
    blk = SwinTransformerBlock(8, (4, 4, 4), 8, 2, 1, 3, attn_drop=0.1).train()
    init_weights(blk, torch.Generator().manual_seed(2))
    blk.fused_block = False
    x = torch.randn(1, 4, 4, 4, 8, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="set_dropout_generator"):
        blk(x)
    blk.set_dropout_generator(torch.Generator().manual_seed(1))
    a, b = blk(x), blk(x)
    assert torch.isfinite(a).all() and not torch.equal(a, b)
    assert torch.equal(blk.eval()(x), blk(x))          # no dropout in eval
