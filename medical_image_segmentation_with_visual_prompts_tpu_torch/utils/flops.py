"""FLOP accounting and the card's peaks.

Counterpart of the JAX package's ``utils/flops.py``.  There the count is
XLA's cost analysis of the lowered forward; here it is analytic, from the
config alone (:func:`model_flops`), so a benchmark divides by it without
running anything, and :func:`counted_flops` is the counter
(``torch.utils.flop_counter.FlopCounterMode``) that holds it.

**Three counts of one forward** (:func:`forward_flops`), all of them
products only, two FLOPs per multiply-add:

* ``model`` -- what an MFU divides by: the patch-embed conv; per Swin
  block the q/k/v, projection and MLP linears over every row of every
  window, the windows padded as the model's ``pad_mode`` pads them (the
  reference's computation), and the two attention products of each
  window's rows over its keys plus the prompt tokens' keys, whose K/V
  rows are projected once per block call (every window shares them);
  patch merging; the bottleneck, skip and decoder convs (a transposed
  conv at its true multiply-adds, no zero insertion); the head.  A
  "same" 3x3x3 conv counts all 27 taps at every voxel.
* ``port`` -- the port's plain forward as executed on fresh operand
  caches; :func:`counted_flops` of it equals this to the FLOP.  Beyond
  ``model`` it computes the per-axis positional-bias tables and the
  prompt-token scores once per block call, the trilinear upsamples as
  dense per-axis interpolation matrices, and, where a block pad-folds
  (``pad_mode: aligned`` with a depth smaller than the window), content
  windows only plus one fold key column per window and its K/V row,
  in place of the padded windows.
* ``jax`` -- the JAX package's fp32 XLA forward: the sum over its jaxpr's
  ``dot_general`` and ``conv_general_dilated`` equations of 2 x output
  elements x contraction size.  Beyond ``model`` it computes the same
  bias tables and interpolation matrices as the port, projects q, k and
  v of the prompt rows in every window, and writes a transposed conv as
  an input-dilated conv (2^3 times the taps, zeros included); it never
  pad-folds.

``model`` is the MFU denominator: it does not move when an
implementation folds a padding away or caches an operand.  At
``tests/test_torch_swin_unetr.py``'s tiny aligned config the three agree
but for the bias tables, the interpolations and the JAX prompt rows
(``model`` 8,802,304; ``port`` 9,189,888; ``jax`` 9,243,136).

**XLA's cost analysis** (the JAX ``lowered_flops``) differs from the
jaxpr's products both ways: it counts only the taps of a conv that fall
inside its input (a 3x3x3 "same" conv on a 2x2x2 grid: 8 taps per voxel,
not 27) and it adds the elementwise arithmetic (one per element per
add, multiply, compare; transcendentals apart).  On a small grid the
border taps it drops outweigh the elementwise work: 8.49e6 against the
port's 9.19e6 at 16x16x8 (ratio 1.08).  At 32x32x8 with a 4x4x4 window
the JAX forward pads the depth-2 stage's windows materially, where the
port folds them, and projects the prompt rows in every window: 4.79e7
against 4.18e7 (0.87).  The flagship's 24.43 GFLOP per 128x128x8 window
(``bench.py``) is that cost analysis, not a product count.

:data:`PEAK_TFLOPS` and :data:`PEAK_TBYTES` are the dense bf16 tensor-core
peaks and the memory rates of NVIDIA's H100 data sheet, keyed by
``torch.cuda.get_device_name()``; an unknown card raises.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import PHASE1_MODE, SUPERVISED_MODES, ModelConfig
from ..ops.windows import compute_paddings, fold_geometry, unpad_paddings

# Dense bf16 tensor-core TFLOP/s (no sparsity) and memory TB/s, NVIDIA
# H100 data sheet, by torch.cuda.get_device_name().
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4,     # H100 SXM5
    "NVIDIA H100 NVL": 835.0,
    "NVIDIA H100 PCIe": 756.0,
}
PEAK_TBYTES = {
    "NVIDIA H100 80GB HBM3": 3.35,
    "NVIDIA H100 NVL": 3.9,
    "NVIDIA H100 PCIe": 2.0,
}


def _peak(table: dict, what: str, device) -> float:
    name = torch.cuda.get_device_name(device)
    if name not in table:
        raise KeyError(f"no {what} known for the device {name!r} "
                       f"(known: {sorted(table)})")
    return table[name]


def chip_peak_tflops(device=None) -> float:
    """Dense bf16 peak TFLOP/s of the CUDA device (default: current)."""
    return _peak(PEAK_TFLOPS, "bf16 peak", device)


def chip_peak_tbytes(device=None) -> float:
    """Memory rate in TB/s of the CUDA device (default: current)."""
    return _peak(PEAK_TBYTES, "memory rate", device)


def counted_flops(fn, *args, **kwargs) -> int:
    """FLOPs of the products (matmuls, convolutions) that ``fn(*args,
    **kwargs)`` runs, counted by ``FlopCounterMode`` under
    ``torch.no_grad()`` (it cannot count under ``inference_mode``).  Give
    it the plain path: a kernel launch is not a torch op it sees."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


@dataclasses.dataclass(frozen=True)
class FlopCount:
    """One forward's products in the three counts (module docstring);
    ``parts`` is ``model`` by part of the network."""

    model: int
    port: int
    jax: int
    parts: Dict[str, int]


class _Tally:
    def __init__(self):
        self.parts: Counter = Counter()
        self.port = 0
        self.jax = 0

    def add(self, part: str, model: int, port: Optional[int] = None,
            jax: Optional[int] = None) -> None:
        self.parts[part] += model
        self.port += model if port is None else port
        self.jax += model if jax is None else jax


def _vol(dims: Sequence[int]) -> int:
    return int(np.prod(dims))


def _conv(t: _Tally, part: str, b: int, dims, k: int, cin: int,
          cout: int) -> None:
    """A stride-1 "same" conv of kernel ``k^3`` at ``dims``."""
    t.add(part, 2 * b * _vol(dims) * k ** 3 * cin * cout)


def _resize(t: _Tally, b: int, dims, out, c: int) -> Tuple[int, ...]:
    """A trilinear resize as the two implementations run it: one dense
    interpolation matrix per changed axis, H then W then D."""
    cur = list(dims)
    for ax in range(3):
        if out[ax] != cur[ax]:
            rest = _vol(cur) // cur[ax]
            n = 2 * b * out[ax] * cur[ax] * rest * c
            t.add("interpolation", 0, n, n)
            cur[ax] = out[ax]
    return tuple(cur)


def _block(t: _Tally, part: str, b: int, dims, c: int, heads: int,
           mc: ModelConfig, tokens: int) -> None:
    """One Swin block (the shift changes no count)."""
    ws = mc.attn_window_size
    pads = compute_paddings(dims, ws, mc.pad_mode)
    padded = [d + pads[2 * i] + pads[2 * i + 1] for i, d in enumerate(dims)]
    p = _vol(padded) // _vol(ws)
    m = _vol(ws)
    rows = b * p * m
    # Model: padded windows, prompt K/V once per call.
    model_lin = 10 * rows * c * c
    model_kv = 4 * tokens * c * c
    model_att = 4 * rows * (m + tokens) * c
    # Port: the pad-folded content windows where the block folds.
    fold_axes = tuple(i for i, d in enumerate(dims) if d < ws[i])
    wc, pads_eff = fold_geometry(dims, ws, fold_axes, pads)
    if fold_axes and not any(pads_eff) and \
            pads == unpad_paddings(pads, mc.pad_mode):
        pm, mm, ext = _vol(dims) // _vol(wc), _vol(wc), 1 + tokens
    else:
        pm, mm, ext = p, m, tokens
    prows = b * pm * mm
    port_lin = 10 * prows * c * c
    port_kv = 4 * ext * c * c
    port_att = 4 * prows * (mm + ext) * c
    # JAX: q/k/v over the content and prompt rows of every window.
    jax_lin = 6 * b * p * (m + tokens) * c * c + 4 * rows * c * c
    t.add(f"{part}.linear", model_lin, port_lin, jax_lin)
    t.add(f"{part}.prompt_kv", model_kv, port_kv, 0)
    t.add(f"{part}.attention", model_att, port_att, model_att)
    # Positional-bias tables: per axis [heads, E] x [w, w, E], and the
    # prompt columns' scores [heads, E] x [T, E].
    e = mc.pos_bias_embed_dim
    bias = 2 * heads * e * (sum(w * w for w in ws) + tokens)
    t.add("bias_tables", 0, bias, bias)


def _pair(t, part, b, dims, c, heads, mc, tokens) -> None:
    for i in range(2):
        _block(t, f"{part}.block{i}", b, dims, c, heads, mc, tokens)


def _merge(t, part, b, dims, c, cout, merge_last: bool):
    """Patch merging: odd axes padded by one, 2x2x2 (or 2x2x1) gathered,
    a Linear to ``cout``."""
    even = [d + d % 2 for d in dims]
    out = (even[0] // 2, even[1] // 2, even[2] // 2 if merge_last
           else even[2])
    t.add(f"{part}.merge", 2 * b * _vol(out) * (8 if merge_last else 4)
          * c * cout)
    return out


def _unet_block(t, part, b, dims, cin, cout, residual: bool) -> None:
    _conv(t, part, b, dims, 3, cin, cout)
    _conv(t, part, b, dims, 3, cout, cout)
    if residual and cin != cout:
        _conv(t, part, b, dims, 1, cin, cout)


def _up_block(t, part, b, x_dims, skip_dims, cin, cout, strides, mc,
              tokens) -> None:
    if mc.unetr_up_block == "swin":
        up = tuple(int(d * s) for d, s in zip(x_dims, strides))
        _resize(t, b, x_dims, up, cin)
        _conv(t, f"{part}.conv", b, skip_dims, 3, cin + cout, cout)
        _pair(t, part, b, skip_dims, cout, mc.num_heads_decoder, mc, tokens)
        return
    # UNETR: a 2x2x2 transposed conv (kernel = stride), the crop, the
    # conv block on [up, skip].
    true = 2 * b * _vol(x_dims) * 8 * cin * cout
    t.add(f"{part}.transp_conv", true, true, 8 * true)
    _unet_block(t, f"{part}.conv_block", b, skip_dims, 2 * cout, cout,
                mc.res_block)


def _model_config(conf) -> ModelConfig:
    return conf if isinstance(conf, ModelConfig) else \
        ModelConfig.from_mapping(conf)


def forward_flops(conf, batch: int = 1,
                  roi: Optional[Sequence[int]] = None) -> FlopCount:
    """The products of one forward of ``batch`` crops at ``roi`` (default:
    the config's ``roi_size``) of the segmentation model that ``conf``
    (a config mapping, namespace or ``ModelConfig``) builds, in the three
    counts of the module docstring.  The phase-1 encoder and its heads are
    not counted (:func:`counted_flops` counts a phase-1 step)."""
    mc = _model_config(conf)
    if mc.training_mode == PHASE1_MODE:
        raise ValueError("forward_flops counts the segmentation model's "
                         f"forward, not {PHASE1_MODE!r}'s encoder and heads")
    if roi is None:
        roi = conf["roi_size"] if isinstance(conf, dict) else conf.roi_size
    b, depth, hc = int(batch), mc.depth_unet, mc.hidden_channels
    t = _Tally()
    enc_tok = mc.tokens_per_prompt_encoder if mc.use_encoder_prompting else 0
    dec_tok = mc.tokens_per_prompt_decoder if mc.use_decoder_prompting else 0
    dims = tuple(int(s) // p for s, p in zip(roi, mc.input_patch_size))
    t.add("patch_embed", 2 * b * _vol(dims) * _vol(mc.input_patch_size)
          * mc.input_channels * hc[0])
    feats = [(dims, hc[0]), (tuple(int(s) for s in roi), mc.input_channels)]
    for i in range(depth):
        _pair(t, f"encoder{i}", b, dims, hc[i], mc.num_heads_encoder * 2 ** i,
              mc, enc_tok)
        dims = _merge(t, f"encoder{i}", b, dims, hc[i], 2 * hc[i], i < 1)
        feats.insert(0, (dims, 2 * hc[i]))
    res = mc.unetr_res_block
    (dims, c), skips = feats[0], feats[1:]
    if res == "full":
        _unet_block(t, "bottleneck", b, dims, c, c, mc.basic_block_res)
    else:
        _conv(t, "bottleneck", b, dims, 3, c, c)
    in_chs = [hc[i] for i in range(depth)][::-1]

    def skip(i):
        s_dims, s_c = skips[i]
        cout = in_chs[min(i, depth - 1)]
        if res == "simple":
            _conv(t, f"skip{i}", b, s_dims, 3, s_c, cout)
        elif res == "full":
            _unet_block(t, f"skip{i}", b, s_dims, s_c, cout,
                        mc.basic_block_res)
        return s_dims

    for j in range(depth):
        s_dims = skip(j)
        strides = (2, 2, 1 if j < depth - 1 else 2)
        _up_block(t, f"decoder{j}", b, dims, s_dims, c, in_chs[j], strides,
                  mc, dec_tok)
        dims, c = s_dims, in_chs[j]
    if res == "none":
        dims = _resize(t, b, dims, tuple(2 * d for d in dims), c)
    else:
        s_dims = skip(depth)
        out_tok = dec_tok if mc.unetr_up_block == "swin" else 0
        _up_block(t, "output", b, dims, s_dims, c, c, (2, 2, 2), mc, out_tok)
        dims = s_dims
    classes = mc.output_channels_downstream \
        if mc.training_mode == "downstream" else \
        mc.output_channels_pretrain if mc.training_mode in SUPERVISED_MODES \
        else 0
    if classes:
        _conv(t, "head", b, dims, 3, c, classes)
    return FlopCount(sum(t.parts.values()), t.port, t.jax, dict(t.parts))


def model_flops(conf, batch: int = 1,
                roi: Optional[Sequence[int]] = None) -> int:
    """The model FLOPs of one forward (:func:`forward_flops`' ``model``):
    what an MFU divides by."""
    return forward_flops(conf, batch, roi).model
