"""PyTorch port: the one-call Swin block pair (B5's path) against the JAX
package's pair kernel and against the port's own two-block path.

Small size: C 8, 2 heads, window 4x4x4, 3 prompt tokens, on the shapes of
``tests/test_pair_kernel.py``: a window-permuted shift, a pure roll,
folded depth and an unshifted pair.  Tolerances:

* vs the JAX pair kernel in interpret mode: 4e-2 absolute on O(1)
  outputs, the bound of ``tests/test_torch_fused_block.py`` for one block
  (the kernel feeds P to P.V as bf16, and rounds every matmul output to
  bf16 where the port keeps fp32); the JAX package holds its own pair
  kernel to its XLA path with the same 4e-2.
* vs the port's two-block path: bit for bit (the same plain arithmetic on
  the same windows, counters and seeds; only the row order differs).
* gradients vs ``jax.grad`` through the JAX pair path (its custom VJP):
  the JAX package's own bound for that comparison, a Frobenius error of
  at most 10% of the reference gradient plus 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from medical_image_segmentation_with_visual_prompts_tpu.models import \
    ConsecutiveSwinBlocks as JaxPair
from medical_image_segmentation_with_visual_prompts_tpu.ops import \
    fused_block as jax_fb
from medical_image_segmentation_with_visual_prompts_tpu.ops import \
    window_attention_pallas as wap
from medical_image_segmentation_with_visual_prompts_tpu.ops import \
    windows as jax_windows
from medical_image_segmentation_with_visual_prompts_tpu.utils.torch_import \
    import _swin_block_rules
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    ConsecutiveSwinBlocks
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    swin_block as port_swin_block
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block as fb
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_pair as fp
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    windows as port_windows

KERNEL_ATOL = 4e-2
C, HEADS, TOKENS, WINDOW = 8, 2, 3, (4, 4, 4)
# (shape, MIVP_FORCE_G of the JAX kernel): tests/test_pair_kernel.py:48-52.
CASES = [((2, 16, 16, 4, 8), "2"), ((2, 8, 8, 4, 8), "0"),
         ((2, 16, 16, 2, 8), "2"), ((1, 4, 4, 4, 8), "0")]
IDS = ["permuted_shift", "pure_roll", "folded_depth", "unshifted"]


def _jax_pair(drop=0.0):
    return JaxPair(hidden_channels=C, num_heads=HEADS, pos_bias_embed_dim=8,
                   max_prompts=1, tokens_per_prompt=TOKENS,
                   use_token_params=True, window_size=WINDOW, down=False,
                   attn_drop=drop, proj_drop=drop, pad_mode="aligned")


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    toks = [rng.standard_normal((TOKENS, shape[-1])).astype(np.float32)
            for _ in range(2)]
    return x, toks


def _jax_args(x, toks):
    ps = tuple(jnp.broadcast_to(jnp.asarray(t)[None], (x.shape[0], *t.shape))
               for t in toks)
    return jnp.asarray(x), ps


def _port_pair(variables, dtype=torch.float32, drop=0.0):
    """The port's pair on the JAX pair's parameters (the reference key
    rules of ``torch_import``)."""
    flat = traverse_util.flatten_dict({"params": variables["params"]},
                                      sep="/")
    sd = {}
    for i in range(2):
        for key, rule in _swin_block_rules(f"swin_blocks.{i}",
                                           f"swin_blocks_{i}", 1).items():
            if rule is None:
                continue
            coll, path, fn = rule
            a = np.asarray(flat[f"{coll}/{path}"])
            sd[key] = torch.from_numpy(np.array(
                a[fn[1]] if isinstance(fn, tuple) else fn(a)))
    pair = ConsecutiveSwinBlocks(C, HEADS, 8, 1, TOKENS, WINDOW, down=False,
                                 pad_mode="aligned", dtype=dtype,
                                 attn_drop=drop, proj_drop=drop)
    pair.load_state_dict(sd, strict=True)
    return pair.eval()


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    shape, force_g = request.param
    x, toks = _inputs(shape)
    variables = _jax_pair().init(jax.random.PRNGKey(2), *_jax_args(x, toks))
    return shape, force_g, x, toks, variables


def _tokens(toks, dtype=torch.float32):
    return tuple(torch.from_numpy(t).to(dtype) for t in toks)


def test_pair_path_matches_jax_pair_kernel(case, monkeypatch):
    """(a) The port's pair path (plain versions, CPU) against the JAX pair
    kernel in interpret mode, which must really run."""
    shape, force_g, x, toks, variables = case
    monkeypatch.setattr(wap, "_FORCE_INTERPRET", True)
    monkeypatch.setenv("MIVP_PAIR_KERNEL", "1")
    monkeypatch.delenv("MIVP_NO_PAIR_KERNEL", raising=False)
    if force_g != "0":
        monkeypatch.setenv("MIVP_FORCE_G", force_g)
    ran = []
    forward_pair = jax_fb._forward_pair
    monkeypatch.setattr(jax_fb, "_forward_pair",
                        lambda *a, **k: ran.append(1) or forward_pair(*a, **k))
    want = np.asarray(_jax_pair().apply(variables, *_jax_args(x, toks)))
    assert ran, "the JAX pair kernel did not run"
    pair = _port_pair(variables, torch.bfloat16)     # the kernels' rounding
    pair.pair_kernel = True
    tokens = _tokens(toks)
    assert pair.pair_plan(torch.from_numpy(x), tokens) is not None
    with torch.inference_mode():
        got = pair(torch.from_numpy(x), tokens).numpy()
    np.testing.assert_allclose(got, want, atol=KERNEL_ATOL, rtol=0)


@pytest.mark.parametrize("drop", [0.0, 0.2], ids=["eval", "train_dropout"])
def test_pair_path_equals_two_block_path_bitwise(case, drop):
    """(b) Pair path == the two block calls, bit for bit, in eval mode and
    in train mode with dropout (same seeds, counters and labels)."""
    shape, _, x, toks, variables = case
    pair = _port_pair(variables, torch.bfloat16, drop)
    if drop:
        pair.train()
    xt = torch.from_numpy(x).to(torch.bfloat16)
    outs, grads = [], []
    for on in (False, True):
        pair.pair_kernel = on
        for blk in pair.swin_blocks:
            blk.set_dropout_generator(torch.Generator().manual_seed(11))
        pair.zero_grad()
        xg = xt.clone().requires_grad_()
        out = pair(xg, _tokens(toks))
        out.float().square().sum().backward()
        outs.append(out.detach())
        grads.append([xg.grad] + [p.grad for p in pair.parameters()])
    assert pair.pair_plan(xt, _tokens(toks)) is not None
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert a is not None and torch.equal(a, b)


@pytest.mark.parametrize("shape", [c[0] for c in CASES], ids=IDS)
def test_pair_plan_is_the_jax_window_shift(shape):
    """(c) The plan's gather is JAX ``window_shift(window_partition(x))``
    (and its inverse gather undoes it)."""
    dims = shape[1:4]
    fold_axes = tuple(i for i, d in enumerate(dims) if d < WINDOW[i])
    wc, _ = port_windows.fold_geometry(dims, WINDOW, fold_axes, (0,) * 6)
    grid = tuple(d // w for d, w in zip(dims, wc))
    shift = tuple(0 if d <= w else w // 2 for d, w in zip(dims, WINDOW))
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_windows.window_shift(
        jax_windows.window_partition(jnp.asarray(x), wc), grid, wc, shift))
    plan = port_windows.pair_plan(dims, wc, shift, torch.device("cpu"))
    x_win = port_windows.window_partition(torch.from_numpy(x), wc)
    got = fp.plan_gather(x_win, plan.index)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(fp.plan_gather(got, plan.inverse), x_win)
    m = int(np.prod(wc))
    flat = (plan.src[:, None].long() * m + plan.tok.long()).reshape(-1)
    assert torch.equal(flat, plan.index)


def test_pair_plan_refuses_a_depth_shift():
    cpu = torch.device("cpu")
    assert port_windows.pair_plan((8, 8, 8), WINDOW, (2, 2, 2), cpu) is None
    assert jax_windows.kernel_shift_plan((2, 2, 2), WINDOW, (2, 2, 2),
                                         1) is None
    assert port_windows.pair_plan((8, 8, 8), WINDOW, (2, 2, 0),
                                  cpu) is not None


def test_pair_gradients_match_jax(monkeypatch):
    """(d) Gradients through ``FusedPairFunction`` (CPU: the plain chain)
    against ``jax.grad`` through the JAX pair path, in x and every block
    parameter (tests/test_pair_kernel.py:87-105)."""
    shape = CASES[0][0]
    x, toks = _inputs(shape)
    xj, ps = _jax_args(x, toks)
    variables = _jax_pair().init(jax.random.PRNGKey(2), xj, ps)
    monkeypatch.setattr(wap, "_FORCE_INTERPRET", True)
    monkeypatch.setenv("MIVP_PAIR_KERNEL", "1")
    monkeypatch.setenv("MIVP_FORCE_G", "2")
    g_params, g_x = jax.grad(
        lambda v, xx: jnp.sum(_jax_pair().apply(v, xx, ps) ** 2),
        argnums=(0, 1))(variables, xj)
    pair = _port_pair(variables)
    pair.pair_kernel = True
    applied = []
    monkeypatch.setattr(fp.FusedPairFunction, "apply",
                        lambda *a, _f=fp.FusedPairFunction.apply:
                        applied.append(1) or _f(*a))
    xt = torch.from_numpy(x).requires_grad_()
    pair(xt, _tokens(toks)).square().sum().backward()
    assert applied, "the pair's autograd Function did not run"
    flat = traverse_util.flatten_dict({"params": g_params["params"]},
                                      sep="/")
    pairs = [(xt.grad.numpy(), np.asarray(g_x))]
    named = dict(pair.named_parameters())
    for i in range(2):
        for key, rule in _swin_block_rules(f"swin_blocks.{i}",
                                           f"swin_blocks_{i}", 1).items():
            if rule is None:
                continue
            _, path, fn = rule
            a = np.asarray(flat[f"params/{path}"])
            pairs.append((named[key].grad.numpy(),
                          a[fn[1]] if isinstance(fn, tuple) else fn(a)))
    for got, want in pairs:
        err = np.linalg.norm(got - want)
        assert err <= 0.1 * np.linalg.norm(want) + 1e-3, (err, got.shape)


GATE_SHAPES = [c[0] for c in CASES] + [(1, 6, 8, 4, 8), (1, 8, 8, 3, 8)]


@pytest.mark.parametrize("shape", GATE_SHAPES)
@pytest.mark.parametrize("pad_mode", ["aligned", "reference"])
def test_gate_mirrors_jax_pair_fusable(shape, pad_mode, monkeypatch):
    """(e) The port takes the pair path exactly where the JAX package's
    ``_pair_fusable`` does (material padding, pad-fold, the pad split),
    only with the switch on, and never for unfused blocks."""
    monkeypatch.setattr(wap, "_FORCE_INTERPRET", True)
    monkeypatch.delenv("MIVP_NO_FUSED_BLOCK", raising=False)
    x, toks = _inputs(shape)
    jpair = JaxPair(hidden_channels=C, num_heads=HEADS, pos_bias_embed_dim=8,
                    max_prompts=1, tokens_per_prompt=TOKENS,
                    use_token_params=True, window_size=WINDOW, down=False,
                    pad_mode=pad_mode)
    # The gate reads the module's fields only: no parameters needed.
    want = jpair.apply({}, shape[1:4], method=JaxPair._pair_fusable)
    pair = ConsecutiveSwinBlocks(C, HEADS, 8, 1, TOKENS, WINDOW, down=False,
                                 pad_mode=pad_mode)
    xt = torch.from_numpy(x)
    assert pair.pair_plan(xt, _tokens(toks)) is None        # switch off
    pair.pair_kernel = True
    assert (pair.pair_plan(xt, _tokens(toks)) is not None) == want
    assert pair.pair_plan(xt, (None, _tokens(toks)[1])) is None  # tokens
    for blk in pair.swin_blocks:
        blk.fused_block = False
    assert pair.pair_plan(xt, _tokens(toks)) is None
    if shape == CASES[0][0]:
        assert want


def test_wrapper_rejects_bad_calls_before_any_launch(case):
    """(f) Argument checks name the argument; CPU tensors never launch."""
    shape, _, x, toks, variables = case
    pair = _port_pair(variables)
    pair.pair_kernel = True
    with torch.no_grad():
        x_win, ops0, ops1, labels, plan, _ = pair.pair_windows(
            torch.from_numpy(x), _tokens(toks))
    before = fp.fused_swin_pair.launches
    with pytest.raises(ValueError, match="x_win has C=4"):
        fp.fused_swin_pair(x_win[..., :4].contiguous(), ops0, ops1, labels,
                           plan)
    with pytest.raises(ValueError, match="plan must have"):
        fp.fused_swin_pair(x_win, ops0, ops1, labels,
                           plan._replace(tok=plan.tok[:, :-1]))
    if labels is not None:
        with pytest.raises(ValueError, match="labels must be"):
            fp.fused_swin_pair(x_win, ops0, ops1, labels[:, :-1], plan)
    other = fb.make_operands(
        {k: v.detach() for k, v in
         pair.swin_blocks[0].block_params().items()}, None,
        ops0.bias[:, :, :ops0.bias.shape[1]], fb.FOLD_NONE, HEADS,
        ops0.scale, ops0.matmul_dtype)
    with pytest.raises(ValueError, match="ops0 and ops1 differ in n_ext"):
        fp.fused_swin_pair(x_win, other, ops1, labels, plan)
    with pytest.raises(ValueError, match="x_win must be on a CUDA device"):
        fp._check_kernel_pair_args(x_win.bfloat16(), ops0, ops1, labels,
                                   plan)
    with torch.inference_mode():
        fp.fused_swin_pair(x_win, ops0, ops1, labels, plan)   # plain version
    assert fp.fused_swin_pair.launches == before


@pytest.fixture(scope="module")
def tiny_model():
    from test_torch_swin_unetr import jax_model, tiny_conf
    from medical_image_segmentation_with_visual_prompts_tpu.utils \
        .torch_export import export_state_dict
    conf = tiny_conf(pad_mode="aligned", attn_impl="auto")
    jm, jconf, variables = jax_model(conf)
    x = np.random.default_rng(3).standard_normal(
        (1, *conf["roi_size"], 1)).astype(np.float32)
    return conf, jm, variables, export_state_dict(variables, jconf), x


def test_tiny_model_pair_path_matches_jax(tiny_model, monkeypatch):
    """(g) The tiny SwinUnetR with ``set_pair_kernel(True)`` against the
    JAX model under ``MIVP_PAIR_KERNEL=1`` with interpret-mode kernels
    (4e-2, as above: the JAX model runs its bf16-operand kernels) and
    against the port's two-block path (bit for bit), which
    tests/test_torch_swin_unetr.py holds to the JAX XLA model at 1e-4."""
    from test_torch_swin_unetr import port_model
    conf, jm, variables, sd, x = tiny_model
    monkeypatch.setattr(wap, "_FORCE_INTERPRET", True)
    monkeypatch.setenv("MIVP_PAIR_KERNEL", "1")
    monkeypatch.delenv("MIVP_NO_PAIR_KERNEL", raising=False)
    ran = []
    forward_pair = jax_fb._forward_pair
    monkeypatch.setattr(jax_fb, "_forward_pair",
                        lambda *a, **k: ran.append(1) or forward_pair(*a, **k))
    want = np.asarray(jm.apply(variables, jnp.asarray(x),
                               deterministic=True)["downstream"])
    assert ran, "the JAX model ran no pair kernel"
    model = port_model(conf, sd)
    pairs = []
    monkeypatch.setattr(port_swin_block, "fused_swin_pair",
                        lambda *a, _f=fp.fused_swin_pair:
                        pairs.append(1) or _f(*a))
    with torch.inference_mode():
        two = model(torch.from_numpy(x)).numpy()
        got = model.set_pair_kernel(True)(torch.from_numpy(x)).numpy()
    assert pairs, "the port ran no pair call"
    np.testing.assert_array_equal(got, two)
    np.testing.assert_allclose(got, want, atol=KERNEL_ATOL, rtol=0)


def test_pair_switch_is_read_once_at_build(monkeypatch):
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import ModelConfig
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from test_torch_swin_unetr import tiny_conf
    mc = ModelConfig.from_mapping(tiny_conf())

    def flags(model):
        return {m.pair_kernel for m in model.modules()
                if hasattr(m, "pair_kernel")}

    monkeypatch.delenv("MIVP_NO_PAIR_KERNEL", raising=False)
    monkeypatch.delenv("MIVP_PAIR_KERNEL", raising=False)
    assert flags(SwinUnetR(mc)) == {False}                  # opt-in
    monkeypatch.setenv("MIVP_PAIR_KERNEL", "1")
    model = SwinUnetR(mc)
    assert flags(model) == {True}
    monkeypatch.setenv("MIVP_PAIR_KERNEL", "0")
    assert flags(model) == {True}                           # read at build
    monkeypatch.setenv("MIVP_PAIR_KERNEL", "1")
    monkeypatch.setenv("MIVP_NO_PAIR_KERNEL", "1")
    assert flags(SwinUnetR(mc)) == {False}                  # NO_ wins
    assert flags(SwinUnetR(mc).set_pair_kernel(True)) == {True}
