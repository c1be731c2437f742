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
  only, fp32 or bf16 ``x_win`` and ``dout``, ``dx`` in their dtype; it
  raises on anything the kernel does not take).  A window runs on a
  thread block cluster (:func:`backward_plan`); cross-window sums are
  fp32 partials in one workspace, summed in window order by a second
  kernel, so two runs on the same inputs give the same bits.
  ``block_backward.launches`` counts its calls (one per call, whatever
  it launches) and ``block_backward.big_launches`` those of them in the
  device-memory form, ``block_backward.launches_by_shape`` all of them
  by the per-sample shape of ``x_win`` (``(P, M, C)``);
  :func:`launch_info` gives the launch's shape.  A
  window too large for the shared-memory layout at every cluster size
  (M 256 at C 192) takes the kernel's device-memory form
  (``BackwardPlan.big``: LN1 of the rows and the gathered [dQ dK dV]
  rows in the workspace).
* :func:`block_backward_reference` is the autograd of
  ``fused_block.block_reference`` (the plain version; CPU tests and the
  comparison on the card).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Optional

import torch

from .fused_block import (FOLD_NONE, NO_DROPOUT, PARAM_KEYS, BlockOperands,
                          Dropout, _check_args, block_reference,
                          check_kernel_args, is_f32)

# The kernel's operands, in the order of its C entry's pointer array
# (``ops/fused_block.py::_kernel_layout`` keys).
_OPERANDS = ("wqkv_kp", "ext_kv", "pe_tab", "pe_coord", "ln1_scale",
             "ln1_bias", "wproj_kp", "wproj_io_kp", "bproj", "ln2_scale",
             "ln2_bias", "wmlp_kp", "wmlp_io_kp", "bmlp", "wqkv_io_kp")
SMEM_PER_CTA = 227 * 1024     # shared bytes a CTA may use (H100)
SMEM_PER_SM = 228 * 1024      # shared memory of an SM
SMEM_RESERVED = 1024          # reserved per resident CTA
THREADS_PER_SM = 2048
REGS_PER_SM = 65536


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


def _pad16(v: int) -> int:
    """``v`` rounded up to a multiple of 16 (rows, columns or bytes)."""
    return -(-v // 16) * 16


def row_block(m: int, ks: int) -> int:
    """Rows of each CTA's row phase when a window runs on ``ks`` CTAs
    (``csrc/fused_block_common.cuh::row_block``)."""
    return m if ks == 1 else _pad16(-(-m // ks))


def backward_smem(m: int, n: int, c: int, heads: int, tabw: int,
                  ks: int, big: bool = False) -> int:
    """Shared bytes per CTA of B4 at cluster size ``ks``: the
    ``BwdSmem`` layout of ``csrc/fused_block_bwd.cu``, region for
    region (``big``: its device-memory form, without y and dqkv)."""
    dhk = _pad16(c // heads)
    hk = heads // math.gcd(ks, heads)
    npad, mp, r16 = _pad16(n), -(-m // 32) * 32, _pad16(row_block(m, ks))
    ds, cs, xs, qks = dhk + 8, c + 8, c + 4, 3 * c + 8
    off = 0
    for size in (npad * 4, hk * tabw * 4, m * 4, mp * 8, r16 * 8,
                 hk * mp * 16, mp * 16, hk * mp * ds * 2, r16 * cs * 2,
                 r16 * xs * 4):
        off = _pad16(off + size)
    u = off
    k = _pad16(u + mp * ds * 2)
    end_a = _pad16(_pad16(k + npad * ds * 2) + dhk * (npad + 8) * 2)
    end_r = u
    for size in (r16 * xs * 4, r16 * cs * 2, r16 * cs * 2, r16 * cs * 2):
        end_r = _pad16(end_r + size)
    end_e = _pad16(_pad16(_pad16(k + npad * ds * 2) + npad * ds * 2)
                   + mp * ds * 2)
    dqkv = max(end_e, _pad16(u + r16 * xs * 4))
    y = max(end_a, end_r, end_e if big else _pad16(dqkv + r16 * qks * 2))
    return y if big else _pad16(y + mp * cs * 2)


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """B4's launch: ``ks`` CTAs per window (a thread block cluster),
    ``hs`` head groups of ``heads // hs`` heads times ``qs`` CTAs per
    group (query rows and key tiles split between them), ``threads`` per
    CTA, ``smem`` shared bytes per CTA and ``ctas_per_sm`` that fit by
    threads, registers and shared memory; ``big``: the device-memory form
    (y and dqkv in the workspace)."""

    ks: int
    hs: int
    qs: int
    threads: int
    smem: int
    ctas_per_sm: int
    big: bool = False


def _ctas_per_sm(threads: int, smem: int) -> int:
    regs = 255 if threads == 256 else 128    # the kernel's launch bounds
    return min(THREADS_PER_SM // threads, REGS_PER_SM // (threads * regs),
               SMEM_PER_SM // (smem + SMEM_RESERVED))


@functools.lru_cache(maxsize=256)
def backward_plan(bp: int, m: int, n: int, c: int, heads: int, tabw: int,
                  sms: int = 132, cluster: Optional[int] = None,
                  threads: Optional[int] = None,
                  big: Optional[bool] = None) -> BackwardPlan:
    """The cluster size of a B4 launch over ``bp`` windows, from the
    shapes alone: of the sizes 1, 2, 4, 8 (16 rows or more per CTA) whose
    CTA fits in shared memory, the fewest CTAs per window that reach the
    most CTAs per SM, then more while the grid stays within half a wave
    (``sms`` SMs; every CTA per window beyond that costs more in the work
    each CTA repeats -- LN1 and q|k|v of every row, the row phase's
    steps -- than the SMs it adds bring).  Head groups: ``gcd(ks,
    heads)``; the rest of the cluster splits each group's rows.  Threads
    per CTA: 512 where a CTA walks more than 256 (head, query row) pairs,
    else 256.  ``cluster``, ``threads`` and ``big`` force a choice.  Where
    no cluster size fits, the same choice among the device-memory
    form's."""
    plans = []
    for form in (False, True) if big is None else (big,):
        for ks in (1, 2, 4, 8):
            if ks > 1 and m < 16 * ks:
                break
            smem = backward_smem(m, n, c, heads, tabw, ks, form)
            if smem > SMEM_PER_CTA:
                continue
            hs = math.gcd(ks, heads)
            qs = ks // hs
            rows = (heads // hs) * -(-m // qs)
            t = threads or (512 if rows > 256 else 256)
            plans.append(BackwardPlan(ks, hs, qs, t, smem,
                                      _ctas_per_sm(t, smem), form))
        if plans:
            break
    if cluster is not None:
        for plan in plans:
            if plan.ks == cluster:
                return plan
        raise ValueError(f"block_backward: no cluster of {cluster} CTAs "
                         f"fits M={m}, N={n}, C={c}, {heads} heads")
    if not plans:
        raise ValueError(f"block_backward: no cluster size fits M={m}, "
                         f"N={n}, C={c}, {heads} heads in shared memory")
    best = max(p.ctas_per_sm for p in plans)
    pick = next(i for i, p in enumerate(plans) if p.ctas_per_sm == best)
    while pick + 1 < len(plans) and \
            2 * bp * plans[pick + 1].ks <= sms * plans[pick + 1].ctas_per_sm:
        pick += 1
    return plans[pick]


@functools.lru_cache(maxsize=16)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan(x_win: torch.Tensor, ops: BlockOperands, cluster: Optional[int],
          threads: Optional[int], big: Optional[bool]) -> BackwardPlan:
    b, pw, m, c = x_win.shape
    tabw = ops.kernel["pe_tab"].shape[1]
    sms = _sm_count(x_win.device)
    return backward_plan(b * pw, m, m + ops.n_ext, c, ops.num_heads, tabw,
                         sms, cluster, threads, big)


def _bias_stride(n: int) -> int:
    """Row stride of the bias gradient's partials and output: N rounded
    up to even (``bias_stride``), so its 8-byte stores stay aligned."""
    return n + n % 2


def _part_sizes(m: int, c: int, heads: int, e: int):
    """Floats of the per-window and per-CTA partials (and of the two
    halves of the output): ``bwd_part_w`` and ``bwd_part_c``."""
    n_w = 3 * c * c + 2 * e * c + heads * m * _bias_stride(m + e)
    return -(-n_w // 4) * 4, 2 * c * c + 6 * c


def _big_bytes(bp: int, m: int, c: int, ks: int) -> int:
    """Bytes of the device-memory form's bf16 workspace: y per CTA
    ``[MP, C + 8]`` and dqkv per window ``[MP, 3C + 8]`` (MP: M rounded up
    to 32)."""
    mp = -(-m // 32) * 32
    return 2 * bp * mp * (ks * (c + 8) + 3 * c + 8)


def _big_workspace(ws, bp, m, c, n_w, n_c, ks):
    """Pointers to y and dqkv, after the fp32 partials in ``ws``."""
    mp = -(-m // 32) * 32
    y = ws.data_ptr() + 4 * (bp * n_w + bp * ks * n_c)
    return y, y + 2 * bp * ks * mp * (c + 8)


def _launch(x_win, dout, dx, ops, labels, dropout, plan, ws, out,
            info=None) -> int:
    """Call ``csrc/fused_block_bwd.cu``: launch (B4 and its reduction),
    or (``info`` an int[7] ctypes array) only size the launch."""
    import ctypes
    from . import kernels
    b, pw, m, c = x_win.shape
    k = ops.kernel
    operands = (ctypes.c_void_p * len(_OPERANDS))(
        *(k[key].data_ptr() for key in _OPERANDS))
    n_w, n_c = _part_sizes(m, c, ops.num_heads, ops.n_ext)
    bp = b * pw
    big = (None, None) if ws is None or not plan.big else _big_workspace(
        ws, bp, m, c, n_w, n_c, plan.ks)
    return kernels.library().mivp_fused_block_bwd(
        x_win.data_ptr(), kernels.ptr(dout), kernels.ptr(dx), operands,
        kernels.ptr(labels), kernels.ptr(ws),
        None if ws is None else ws.data_ptr() + 4 * bp * n_w,
        kernels.ptr(out), *big,
        None if info is None else ctypes.addressof(info), int(plan.big),
        bp, m, c, ops.num_heads, c // ops.num_heads, ops.n_ext, pw,
        *ops.factors.dims, int(ops.fold_mode != FOLD_NONE), plan.ks, plan.hs,
        plan.qs, plan.threads, ops.scale, ops.factors.scale,
        *dropout.kernel_args(), ops.drop_cols, is_f32(x_win),
        kernels.stream_of(x_win))


def launch_info(x_win: torch.Tensor, ops: BlockOperands,
                labels: Optional[torch.Tensor] = None,
                dropout: Dropout = NO_DROPOUT,
                cluster: Optional[int] = None,
                threads: Optional[int] = None,
                big: Optional[bool] = None) -> dict:
    """Shape of B4's launch for these arguments (CUDA only; nothing
    runs): cluster size (CTAs per window), CTAs, threads per CTA, CTAs
    per SM, registers, spill bytes per thread, shared bytes per CTA, and
    ``big`` (the device-memory form)."""
    from . import kernels
    check_kernel_args(x_win, ops, labels, "block_backward")
    plan = _plan(x_win, ops, cluster, threads, big)
    info = kernels.info_array()
    kernels.check(_launch(x_win, None, None, ops, labels, dropout, plan, None,
                          None, info), "block_backward")
    return kernels.info_dict(info) | {"big": plan.big}


def block_backward(x_win: torch.Tensor, dout: torch.Tensor,
                   ops: BlockOperands, labels: Optional[torch.Tensor],
                   dropout: Dropout, cluster: Optional[int] = None,
                   threads: Optional[int] = None,
                   big: Optional[bool] = None):
    """Block backward on the card (``csrc/fused_block_bwd.cu``).
    ``cluster``, ``threads`` and ``big`` force the cluster size, the
    threads per CTA and the form (``backward_plan``)."""
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
    plan = _plan(x_win, ops, cluster, threads, big)
    n_w, n_c = _part_sizes(m, c, h, e)
    f32 = dict(device=x_win.device, dtype=torch.float32)
    ws = torch.empty(bp * n_w + bp * plan.ks * n_c + (
        -(-_big_bytes(bp, m, c, plan.ks) // 4) if plan.big else 0), **f32)
    out = torch.empty(n_w + n_c, **f32)
    dx = torch.empty_like(x_win)
    kernels.check(_launch(x_win, dout, dx, ops, labels, dropout, plan, ws,
                          out), "block_backward")
    block_backward.launches += 1
    block_backward.big_launches += plan.big
    block_backward.launches_by_shape[(pw, m, c)] += 1
    cc = c * c
    w = {key: out[i * cc:(i + 1) * cc].view(c, c)
         for i, key in enumerate(("wq", "wk", "wv"))}
    dext = out[3 * cc:3 * cc + 2 * e * c].view(2, e, c)
    nb = _bias_stride(m + e)
    dbias = out[3 * cc + 2 * e * c:3 * cc + 2 * e * c + h * m * nb].view(
        h, m, nb)[:, :, :m + e]
    rest = out[n_w:]
    w["wproj"], w["wmlp"] = rest[:cc].view(c, c), rest[cc:2 * cc].view(c, c)
    for i, key in enumerate(("bproj", "bmlp", "ln1_scale", "ln1_bias",
                             "ln2_scale", "ln2_bias")):
        w[key] = rest[2 * cc + i * c:2 * cc + (i + 1) * c]
    dparams = tuple(w[key] for key in PARAM_KEYS)
    dext_k, dext_v = (dext[0], dext[1]) if e else (None, None)
    return dx, (dbias, dext_k, dext_v, *dparams)


block_backward.launches = 0
block_backward.big_launches = 0
block_backward.launches_by_shape = collections.Counter()
