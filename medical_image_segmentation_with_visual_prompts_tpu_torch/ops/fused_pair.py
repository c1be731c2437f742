"""One-kernel Swin block pair: plain version, CUDA kernel wrapper, counter,
and the autograd Function that trains through both.

Counterpart of the pair half of the JAX package's ``ops/fused_block.py``
(TPU kernel ``_pair_kernel``, run by ``_forward_pair``; its jnp mirror
``_pair_reference``; the gradient ``_fused_pair_bwd``).  One call runs
both blocks of a (no-shift, shift) pair on the UNSHIFTED windows of the
pair's input and returns the unshifted windows of its output::

    x1  = block(x_win, ops0)                      no mask
    out = unshift(block(shift(x1), ops1, labels))

``shift`` is the roll between the blocks as a row map of the windows
(``ops/windows.py::pair_plan``): shifted window ``w'`` of an image draws
its tokens from one source window, ``tok[w', t]`` of ``src[w']``.  Each
``block`` is :func:`ops.fused_block.block_reference`'s arithmetic.
Dropout counters are those of the two-block path: block 1 hashes the
index of its (source) window, block 2 the index of the shifted window,
each with its own two seeds (the JAX kernel's four).

* :func:`pair_reference`: the plain version, ``block_reference``, the
  plan's gather, ``block_reference``, the inverse gather.
* :func:`fused_swin_pair`: CUDA tensors run ``csrc/fused_pair.cu`` (B5;
  ``fused_swin_pair.launches`` counts its launches), CPU tensors the plain
  version.  Its output equals B1 -> gather -> B1 -> inverse gather bit
  for bit: the kernel runs B1's body twice and rounds block 1's output to
  the array dtype where the two-launch path stores it.
* :class:`FusedPairFunction`: forward B5; backward as the JAX package's
  ``_fused_pair_bwd``: block 1's output recomputed with B1 (the source
  windows' counters), gathered with the output gradient, B4 for block 2,
  the inverse gather, B4 for block 1.  On the CPU the same chain runs the
  plain versions (``block_reference`` and the autograd of it), which is
  the chain rule through :func:`pair_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .fused_block import (NO_DROPOUT, BlockOperands, Dropout, _check_args,
                          _forward, block_reference, check_kernel_args,
                          is_f32)
from .fused_block_bwd import block_backward, block_backward_reference
from .windows import PairPlan

# Each block's operands in the order csrc/fused_pair.cu reads them.
_KERNEL_OPERANDS = ("wqkv_kp", "ext_kv", "pe_tab", "pe_coord", "ln1_scale",
                    "ln1_bias", "wproj_kp", "bproj", "ln2_scale", "ln2_bias",
                    "wmlp_kp", "bmlp")


def plan_gather(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``[B, P, M, C]`` windows with their rows taken by a flat per-image
    ``[P*M]`` row index (a :class:`PairPlan`'s ``index`` or ``inverse``)."""
    b, pw, m, c = x.shape
    return x.reshape(b, pw * m, c).index_select(1, index).view(b, pw, m, c)


def pair_reference(x_win: torch.Tensor, ops0: BlockOperands,
                   ops1: BlockOperands, labels: Optional[torch.Tensor],
                   plan: PairPlan, dropout0: Dropout = NO_DROPOUT,
                   dropout1: Dropout = NO_DROPOUT) -> torch.Tensor:
    """Plain PyTorch version of the pair: ``[B, P, M, C]`` unshifted
    windows -> the same.  Differentiable in ``x_win`` and both operand
    sets."""
    x1 = block_reference(x_win, ops0, None, dropout0)
    x2 = block_reference(plan_gather(x1, plan.index), ops1, labels, dropout1)
    return plan_gather(x2, plan.inverse)


def check_pair_args(x_win: torch.Tensor, ops0: BlockOperands,
                    ops1: BlockOperands, labels: Optional[torch.Tensor],
                    plan: PairPlan, name: str = "fused_swin_pair") -> None:
    """Shape checks of both paths; raises naming the argument."""
    _check_args(x_win, ops0, None, f"{name} (ops0)")
    _check_args(x_win, ops1, labels, f"{name} (ops1)")
    for key in ("n_ext", "num_heads", "scale", "drop_cols", "matmul_dtype"):
        if getattr(ops0, key) != getattr(ops1, key):
            raise ValueError(f"{name}: ops0 and ops1 differ in {key} "
                             f"({getattr(ops0, key)} vs {getattr(ops1, key)})")
    _, pw, m, _ = x_win.shape
    if tuple(plan.src.shape) != (pw,) or tuple(plan.tok.shape) != (pw, m):
        raise ValueError(f"{name}: plan must have src [P] and tok [P, M] = "
                         f"{(pw,)}, {(pw, m)}; got {tuple(plan.src.shape)}, "
                         f"{tuple(plan.tok.shape)}")


def _check_kernel_pair_args(x_win, ops0, ops1, labels, plan) -> None:
    """What csrc/fused_pair.cu takes besides B1's checks."""
    name = "fused_swin_pair"
    check_kernel_args(x_win, ops0, None, name)
    check_kernel_args(x_win, ops1, labels, name)
    f0, f1 = ops0.factors, ops1.factors
    if f0.dims != f1.dims or f0.scale != f1.scale or \
            bool(ops0.fold_mode) != bool(ops1.fold_mode):
        raise ValueError(f"{name}: ops0 and ops1 differ in their bias "
                         f"factors' window {f0.dims} vs {f1.dims}, scale "
                         f"{f0.scale} vs {f1.scale} or fold column")
    for key in ("src", "tok"):
        t = getattr(plan, key)
        if t.device != x_win.device or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{name}: plan.{key} must be a contiguous int32 "
                             f"tensor on x_win's device, got {t.dtype} on "
                             f"{t.device}")


def _operand_pointers(ops: BlockOperands):
    return (ctypes.c_void_p * len(_KERNEL_OPERANDS))(
        *(ops.kernel[k].data_ptr() for k in _KERNEL_OPERANDS))


def _launch(x_win, out, ops0, ops1, labels, plan, dropout0, dropout1,
            info=None) -> int:
    """Call ``csrc/fused_pair.cu``: launch into ``out``, or (``info`` an
    int[7] ctypes array) only size the launch."""
    from . import kernels
    b, pw, m, c = x_win.shape
    return kernels.library().mivp_fused_swin_pair(
        x_win.data_ptr(), kernels.ptr(out), plan.src.data_ptr(),
        plan.tok.data_ptr(), kernels.ptr(labels), _operand_pointers(ops0),
        _operand_pointers(ops1),
        None if info is None else ctypes.addressof(info), b * pw, m, c,
        ops0.num_heads, c // ops0.num_heads, ops0.n_ext, pw,
        *ops0.factors.dims, int(bool(ops0.fold_mode)), ops0.scale,
        ops0.factors.scale, *dropout0.kernel_args(), *dropout1.kernel_args(),
        ops0.drop_cols, is_f32(x_win), kernels.stream_of(x_win))


def launch_info(x_win, ops0, ops1, labels, plan, dropout0=NO_DROPOUT,
                dropout1=NO_DROPOUT) -> dict:
    """Shape of B5's launch for these arguments (CUDA only; nothing runs):
    the keys of ``ops/kernels.py::INFO_KEYS``."""
    from . import kernels
    _check_kernel_pair_args(x_win, ops0, ops1, labels, plan)
    info = kernels.info_array()
    kernels.check(_launch(x_win, None, ops0, ops1, labels, plan, dropout0,
                          dropout1, info), "fused_swin_pair")
    return kernels.info_dict(info)


def _pair_forward(x_win, ops0, ops1, labels, plan, dropout0, dropout1):
    """One pair forward: B5 for CUDA tensors, else the plain version."""
    if not x_win.is_cuda:
        return pair_reference(x_win, ops0, ops1, labels, plan, dropout0,
                              dropout1)
    _check_kernel_pair_args(x_win, ops0, ops1, labels, plan)
    from . import kernels
    out = torch.empty_like(x_win)
    kernels.check(_launch(x_win, out, ops0, ops1, labels, plan, dropout0,
                          dropout1), "fused_swin_pair")
    fused_swin_pair.launches += 1
    return out


def pair_backward(x_win: torch.Tensor, dout: torch.Tensor,
                  ops0: BlockOperands, ops1: BlockOperands,
                  labels: Optional[torch.Tensor], plan: PairPlan,
                  dropout0: Dropout, dropout1: Dropout):
    """``(dx, grads0, grads1)`` of the pair, each ``grads`` in
    ``BlockOperands.tensors()`` order.  On the card: block 1's output
    recomputed by B1, then B4 for block 2 and B4 for block 1; on the CPU
    the plain versions in the same chain."""
    bwd = block_backward if x_win.is_cuda else block_backward_reference
    with torch.no_grad():
        x1 = _forward(x_win, ops0, None, dropout0)
    dx1, grads1 = bwd(plan_gather(x1, plan.index),
                      plan_gather(dout, plan.index), ops1, labels, dropout1)
    dx, grads0 = bwd(x_win, plan_gather(dx1, plan.inverse), ops0, None,
                     dropout0)
    return dx, grads0, grads1


class FusedPairFunction(torch.autograd.Function):
    """Forward: B5 (CUDA) or :func:`pair_reference` (CPU).  Backward:
    :func:`pair_backward`.  Saves only ``x_win``, both operand sets, the
    labels, the plan and the seeds, like the JAX ``custom_vjp``
    residuals; block 1's output is recomputed in the backward."""

    @staticmethod
    def forward(ctx, x_win, labels, plan, ops0, ops1, dropout0, dropout1,
                *tensors):
        ctx.save_for_backward(x_win, *tensors)
        ctx.labels, ctx.plan = labels, plan
        ctx.ops, ctx.dropouts = (ops0, ops1), (dropout0, dropout1)
        return _pair_forward(x_win, ops0, ops1, labels, plan, dropout0,
                             dropout1)

    @staticmethod
    def backward(ctx, dout):
        x_win, *tensors = ctx.saved_tensors
        half = len(tensors) // 2
        ops0 = ctx.ops[0].with_tensors(tensors[:half])
        ops1 = ctx.ops[1].with_tensors(tensors[half:])
        dx, grads0, grads1 = pair_backward(
            x_win, dout.contiguous(), ops0, ops1, ctx.labels, ctx.plan,
            *ctx.dropouts)
        return (dx, None, None, None, None, None, None, *grads0, *grads1)


def fused_swin_pair(x_win: torch.Tensor, ops0: BlockOperands,
                    ops1: BlockOperands, labels: Optional[torch.Tensor],
                    plan: PairPlan, dropout0: Dropout = NO_DROPOUT,
                    dropout1: Dropout = NO_DROPOUT) -> torch.Tensor:
    """Run a Swin block pair on unshifted windowed content tokens.

    Args:
      x_win: ``[B, P, M, C]`` unshifted window tokens (pre-LN).
      ops0, ops1: :func:`ops.fused_block.make_operands` of the unshifted
        block and of the shifted block for this geometry (the same token
        count, so the same ``N``).
      labels: ``[P, N]`` int32 labels of the SHIFTED windows, or None.
      plan: :func:`ops.windows.pair_plan` of the shift (on x_win's device).
      dropout0, dropout1: each block's seeds and rates.

    CUDA tensors run ``csrc/fused_pair.cu`` (fp32 or bf16 ``x_win``); CPU
    tensors run :func:`pair_reference`.  When grad is enabled and ``x_win``
    or an operand requires it, the call is differentiable
    (:class:`FusedPairFunction`).
    """
    check_pair_args(x_win, ops0, ops1, labels, plan)
    tensors = (*ops0.tensors(), *ops1.tensors())
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x_win, *tensors)):
        return FusedPairFunction.apply(x_win, labels, plan, ops0, ops1,
                                       dropout0, dropout1, *tensors)
    return _pair_forward(x_win, ops0, ops1, labels, plan, dropout0, dropout1)


fused_swin_pair.launches = 0
