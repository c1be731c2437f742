"""Fused Swin block backward: CUDA kernel wrapper, plain version, counter.

Counterpart of the JAX package's ``ops/fused_block_bwd.py`` (TPU kernel
``_bwd_kernel``).  Given the block's input ``x_win``, its operands, the
labels, the dropout seeds and the output gradient, both functions return
``(dx, grads)`` where ``grads`` follows ``BlockOperands.tensors()``:
``(dbias [H, M, N], dext_k [E, C], dext_v [E, C], *dparams)`` with the
weights in (in, out) layout.  Autograd maps the bias and extra-row
gradients on to the positional-bias parameters and the prompt tokens (the
counterpart of the JAX ``jax.vjp(_operand_args)``).

* :func:`block_backward` runs ``csrc/fused_block_bwd.cu`` (CUDA tensors
  only; it raises on anything the kernel does not take).  Its fp32
  cross-window sums are atomics, so two runs differ by fp32 rounding.
  ``block_backward.launches`` counts its launches.
* :func:`block_backward_reference` is the autograd of
  ``fused_block.block_reference`` (the plain version; CPU tests and the
  comparison on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from .fused_block import (PARAM_KEYS, BlockOperands, Dropout, _check_args,
                          block_reference, check_kernel_args)


def block_backward_reference(x_win: torch.Tensor, dout: torch.Tensor,
                             ops: BlockOperands,
                             labels: Optional[torch.Tensor],
                             dropout: Dropout):
    """Gradients by autograd through :func:`block_reference`."""
    x = x_win.detach().requires_grad_()
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in ops.tensors()]
    with torch.enable_grad():
        out = block_reference(x, ops.with_tensors(leaves), labels, dropout)
    inputs = [x] + [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad(out, inputs, dout, allow_unused=True))
    dx = next(grads)
    dtensors = [None if t is None else next(grads) for t in leaves]
    dtensors = [torch.zeros_like(t) if t is not None and d is None else d
                for t, d in zip(leaves, dtensors)]
    return dx, tuple(dtensors)


def _backward_layout(ops: BlockOperands) -> dict:
    """The extra operands the backward kernel reads: q/k/v weights per
    head in (in, out) order ``[H, 3, C, DHK]`` and the projection and MLP
    weights in (in, out) layout, all bf16."""
    k = ops.kernel
    bf = torch.bfloat16
    return {
        "wqkv_t": k["wqkv"].transpose(-1, -2).contiguous(),
        "wproj_io": ops.params["wproj"].detach().to(bf).contiguous(),
        "wmlp_io": ops.params["wmlp"].detach().to(bf).contiguous(),
    }


def block_backward(x_win: torch.Tensor, dout: torch.Tensor,
                   ops: BlockOperands, labels: Optional[torch.Tensor],
                   dropout: Dropout):
    """Block backward on the card (``csrc/fused_block_bwd.cu``)."""
    _check_args(x_win, ops, labels)
    check_kernel_args(x_win, ops, labels, "block_backward")
    if dout.shape != x_win.shape or dout.dtype != x_win.dtype or \
            not dout.is_contiguous() or dout.device != x_win.device:
        raise ValueError(f"block_backward: dout must be a contiguous "
                         f"{x_win.dtype} tensor of shape "
                         f"{tuple(x_win.shape)} on {x_win.device}, got "
                         f"{dout.dtype} {tuple(dout.shape)} on "
                         f"{dout.device}")
    from . import kernels
    b, pw, m, c = x_win.shape
    bp, h, e = b * pw, ops.num_heads, ops.n_ext
    mp = -(-m // 32) * 32
    dev = x_win.device
    k = ops.kernel
    kb = _backward_layout(ops)
    f32 = dict(device=dev, dtype=torch.float32)
    ws_h = torch.empty((bp, 6, mp, c), device=dev, dtype=torch.bfloat16)
    ws_f = torch.empty((bp, 4, mp, c), **f32)
    ws_s = torch.empty((bp, mp, 4), **f32)
    ws_sm = torch.empty((bp, h, mp, 2), **f32)
    dx = torch.empty_like(x_win)
    dw = {key: torch.zeros((c, c), **f32)
          for key in ("wq", "wk", "wv", "wproj", "wmlp")}
    dvec = {key: torch.zeros((c,), **f32)
            for key in ("bproj", "bmlp", "ln1_scale", "ln1_bias",
                        "ln2_scale", "ln2_bias")}
    dbias = torch.zeros((h, m, m + e), **f32)
    dext = torch.zeros((2, max(e, 1), c), **f32)
    err = kernels.library().mivp_fused_block_bwd(
        x_win.data_ptr(), dout.data_ptr(), dx.data_ptr(),
        k["wqkv"].data_ptr(), kb["wqkv_t"].data_ptr(),
        k["ext_kv"].data_ptr(), k["bias"].data_ptr(), kernels.ptr(labels),
        k["ln1_scale"].data_ptr(), k["ln1_bias"].data_ptr(),
        k["wproj"].data_ptr(), kb["wproj_io"].data_ptr(),
        k["bproj"].data_ptr(), k["ln2_scale"].data_ptr(),
        k["ln2_bias"].data_ptr(), k["wmlp"].data_ptr(),
        kb["wmlp_io"].data_ptr(), k["bmlp"].data_ptr(),
        ws_h.data_ptr(), ws_f.data_ptr(), ws_s.data_ptr(), ws_sm.data_ptr(),
        dw["wq"].data_ptr(), dw["wk"].data_ptr(), dw["wv"].data_ptr(),
        dw["wproj"].data_ptr(), dw["wmlp"].data_ptr(),
        dvec["bproj"].data_ptr(), dvec["bmlp"].data_ptr(),
        dvec["ln1_scale"].data_ptr(), dvec["ln1_bias"].data_ptr(),
        dvec["ln2_scale"].data_ptr(), dvec["ln2_bias"].data_ptr(),
        dbias.data_ptr(), dext.data_ptr(),
        bp, m, c, h, c // h, e, pw, ops.scale, *dropout.kernel_args(),
        ops.drop_cols, kernels.stream_of(x_win))
    kernels.check(err, "block_backward")
    block_backward.launches += 1
    grads = {**dw, **dvec}
    dparams = tuple(grads[key] for key in PARAM_KEYS)
    dext_k, dext_v = (dext[0, :e], dext[1, :e]) if e else (None, None)
    return dx, (dbias, dext_k, dext_v, *dparams)


block_backward.launches = 0
