"""MedSAM's image-encoder attention core (S1): multi-head attention over an
``h x w`` grid with segment_anything's decomposed relative position bias,
from the qkv linear's output to the input of ``proj``::

    s[i, j] = q_i . k_j / sqrt(hd) + q_i . Rh[qh_i - kh_j + h - 1]
                                   + q_i . Rw[qw_i - kw_j + w - 1]
    o_i     = softmax_j(s[i, .]) v

No counterpart in the JAX package's kernels: it has no SAM.  CUDA tensors
run ``csrc/sam_attention.cu``, which reads q, k and v in place from
``qkv`` and keeps ``q . R`` on the chip (its module note).  CPU tensors
take :func:`sam_attention_reference`, the widened-q form the model ran
before this kernel.

On the card the kernel takes head size 64 and, in bf16, grids 64 wide
(up to 64 high: SAM ViT-B's global blocks at 1024^2) or windows up to
16x16 (its 14x14 windows); :func:`kernel_form` chooses the form, raises
on anything else, and nothing falls back to the plain version.

The tables come as ``models/sam.py::Attention.rel_table`` gathers them:
``table_h[qh, kh] = Rh[qh - kh + h - 1]`` ``[h, h, hd]``, and ``table_w``
``[w, w, hd]``.

``sam_attention.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# The kernel's head size; the bf16 kernel's two grid forms (its module
# note): rows of 64 keys (w == 64, h <= 64), or windows (h, w <= 16).
# The kernel takes the form chosen here by its code, 1 + its index in
# ``FORMS``, and refuses a grid the form's shared memory does not hold.
FORMS = ("rows", "windows", "fp32")
HEAD_DIM = 64
ROW_TILE = 64
MAX_WINDOW = 16
MAX_SIDE_F32 = 64


def rel_terms(q: torch.Tensor, table_h: torch.Tensor, table_w: torch.Tensor):
    """``q . Rh`` ``[B, heads, h w, h]`` and ``q . Rw`` ``[B, heads, h w,
    w]`` of the unscaled ``q`` ``[B, heads, h w, hd]``."""
    b, n, m, hd = q.shape
    h, w = table_h.shape[0], table_w.shape[0]
    r_q = q.reshape(b, n, h, w, hd)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, table_h)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, table_w)
    return rel_h.reshape(b, n, m, h), rel_w.reshape(b, n, m, w)


def key_onehots(h: int, w: int, pad: int, like: torch.Tensor) -> torch.Tensor:
    """``[h w, h + w + pad]``: key ``(kh, kw)``'s one-hot of ``kh``, then
    of ``kw``, then zeros."""
    eye_h = torch.eye(h, dtype=like.dtype, device=like.device)
    eye_w = torch.eye(w, dtype=like.dtype, device=like.device)
    return torch.cat([eye_h[:, None].expand(h, w, h),
                      eye_w[None].expand(h, w, w),
                      like.new_zeros(h, w, pad)], -1).reshape(h * w, -1)


def sam_attention_reference(qkv: torch.Tensor, table_h: torch.Tensor,
                            table_w: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version.  The bias is not materialised: q and k are
    widened so that their product is the scaled scores plus the bias,

        q' = [q / sqrt(hd), q . Rh[qh - kh], q . Rw[qw - kw]]  (over kh, kw)
        k' = [k, onehot(kh), onehot(kw)]

    (zero-padded to a multiple of 8), and ``scaled_dot_product_attention``
    runs on ``q'``, ``k'`` and ``v`` at scale 1 with no mask."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    q, k, v = qkv.reshape(b, h * w, 3, heads, c // heads).permute(
        2, 0, 3, 1, 4).unbind(0)
    hd = q.shape[-1]
    rel_h, rel_w = rel_terms(q, table_h, table_w)
    pad = -(hd + h + w) % 8
    q = torch.cat([q * hd ** -0.5, rel_h, rel_w,
                   q.new_zeros(*q.shape[:3], pad)], -1)
    k = torch.cat([k, key_onehots(h, w, pad, k).expand(*k.shape[:2], -1, -1)],
                  -1)
    o = F.scaled_dot_product_attention(q, k, v, scale=1.0)
    return o.transpose(1, 2).reshape(b, h, w, c)


def _check(qkv, table_h, table_w, heads) -> None:
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"sam_attention: qkv must be [B, h, w, 3 heads hd] "
                         f"for {heads} heads, got {tuple(qkv.shape)}")
    _, h, w, c3 = qkv.shape
    hd = c3 // (3 * heads)
    for arg, t, side in (("table_h", table_h, h), ("table_w", table_w, w)):
        if tuple(t.shape) != (side, side, hd):
            raise ValueError(f"sam_attention: {arg} must be [{side}, {side}, "
                             f"{hd}], got {tuple(t.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sam_attention: qkv must be float32 or bfloat16, "
                         f"got {qkv.dtype}")
    for arg, t in (("table_h", table_h), ("table_w", table_w)):
        if t.dtype != qkv.dtype or t.device != qkv.device:
            raise ValueError(f"sam_attention: {arg} must be {qkv.dtype} on "
                             f"{qkv.device}, got {t.dtype} on {t.device}")
    for arg, t in (("qkv", qkv), ("table_h", table_h), ("table_w", table_w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"sam_attention: {arg} must be contiguous and "
                             "16-byte aligned (qkv: the qkv linear's output)")


def kernel_form(qkv: torch.Tensor, heads: int) -> str:
    """Which instance of the kernel takes ``qkv`` (``"rows"``,
    ``"windows"`` or ``"fp32"``); raises on what none takes."""
    b, h, w, c3 = qkv.shape
    hd = c3 // (3 * heads)
    if hd != HEAD_DIM:
        raise ValueError(f"sam_attention: the kernel takes head size "
                         f"{HEAD_DIM}, got {hd}")
    if b > 65535 or heads > 65535:
        raise ValueError(f"sam_attention: at most 65535 images and heads, got "
                         f"{b} and {heads}")
    if qkv.requires_grad:
        raise ValueError("sam_attention: qkv requires grad; the serving "
                         "kernel has no backward")
    if qkv.dtype == torch.float32:
        if max(h, w) > MAX_SIDE_F32:
            raise ValueError(f"sam_attention: the fp32 kernel takes grids up "
                             f"to {MAX_SIDE_F32}x{MAX_SIDE_F32}, got {h}x{w}")
        return "fp32"
    if w == ROW_TILE and h <= ROW_TILE:
        return "rows"
    if max(h, w) <= MAX_WINDOW:
        return "windows"
    raise ValueError(f"sam_attention: the bf16 kernel takes grids {ROW_TILE} "
                     f"wide and up to {ROW_TILE} high, or windows up to "
                     f"{MAX_WINDOW}x{MAX_WINDOW}; got {h}x{w}")


def sam_attention(qkv: torch.Tensor, table_h: torch.Tensor,
                  table_w: torch.Tensor, heads: int) -> torch.Tensor:
    """The attention core of one encoder block: ``qkv`` ``[B, h, w, 3 C]``
    (the qkv linear's output, contiguous), the gathered tables, ``heads``
    heads -> ``o`` ``[B, h, w, C]`` in ``qkv``'s dtype.  CPU tensors: the
    plain version."""
    _check(qkv, table_h, table_w, heads)
    if not qkv.is_cuda:
        return sam_attention_reference(qkv, table_h, table_w, heads)
    from . import kernels
    form = kernel_form(qkv, heads)
    b, h, w, c3 = qkv.shape
    out = torch.empty((b, h, w, c3 // 3), device=qkv.device, dtype=qkv.dtype)
    kernels.check(kernels.library().mivp_sam_attention(
        qkv.data_ptr(), table_h.data_ptr(), table_w.data_ptr(),
        out.data_ptr(), b, h, w, heads, 1 + FORMS.index(form),
        kernels.stream_of(qkv)), "sam_attention")
    sam_attention.launches += 1
    return out


sam_attention.launches = 0


def launch_info(qkv: torch.Tensor, heads: int) -> dict:
    """The launch a call on ``qkv`` makes, asked of the card (CTAs,
    threads, CTAs per SM, registers, spill bytes, shared bytes;
    ``ops/kernels.py::INFO_KEYS``)."""
    from . import kernels
    form = kernel_form(qkv, heads)
    b, h, w, _ = qkv.shape
    info = kernels.info_array()
    kernels.check(kernels.library().mivp_sam_attention_info(
        b, h, w, heads, 1 + FORMS.index(form), info),
        "sam_attention (info)")
    return dict(kernels.info_dict(info), form=form)
