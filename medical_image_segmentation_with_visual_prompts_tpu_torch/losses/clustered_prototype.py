"""Clustered-prototype distillation loss (phase 2).

Counterpart of the JAX package's ``losses/clustered_prototype.py``:

1. the teacher's embeddings are subsampled twice (a prototype grid at
   ``2 * reduction_factor``, a teacher grid at ``reduction_factor``) and
   each student's once at ``reduction_factor`` with a random spatial
   jitter, by trilinear sampling at half-pixel centres;
2. soft k-means over the teacher grid with Gaussian position weights
   (sigma = fwhm / 2.355) re-aggregates the prototypes' embeddings and
   coordinates each iteration;
3. per student: the nearest teacher coordinate within ``max_dist = 4``
   voxels, then the cross-entropy between the student->prototype softmax
   (temperature ``temp_s``) and that teacher point's assignment
   (``temp_t``).

The JAX package's static-shape form is kept: a student's jitter (front
and back crop per axis) moves the sample positions instead of slicing
the volume, and the per-sample mean over the points within reach is
``sum(ce * mask) / max(sum(mask), 1)``, so no point in reach gives 0,
not NaN.  The JAX loss draws each student's jitter from its PRNG key,
which torch cannot reproduce; here the caller passes the jitters (six
ints per student, each in ``[0, ceil(reduction_factor))``;
:func:`draw_jitters`).

Plain PyTorch: no kernel computes this in the JAX package either.
Layout: embeddings ``[B, H, W, D, C]`` channels-last, coordinate grids
``[B, H, W, D, 3]``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch


def draw_jitters(n_students: int, reduction_factor: float,
                 generator: torch.Generator) -> List[List[int]]:
    """One jitter (six ints in ``[0, ceil(reduction_factor))``) per
    student from ``generator``."""
    high = max(int(math.ceil(reduction_factor)), 1)
    return [torch.randint(0, high, (6,), generator=generator).tolist()
            for _ in range(n_students)]


def _axis_positions(length: int, out: int, j0: int, j1: int,
                    device) -> torch.Tensor:
    """Half-pixel sample positions (torch ``affine_grid`` + ``grid_sample``,
    ``align_corners=False``) over the sub-range ``[j0, length - j1)``."""
    eff = length - j0 - j1
    i = torch.arange(out, dtype=torch.float32, device=device)
    return (i + 0.5) * eff / out - 0.5 + j0


def _gather_lerp(x: torch.Tensor, pos: torch.Tensor, axis: int
                 ) -> torch.Tensor:
    """Linear interpolation of ``x`` at float positions ``pos`` along
    ``axis``, the indices clamped to ``[0, L - 1]``."""
    length = x.shape[axis]
    floor = torch.floor(pos)
    lo = floor.long().clamp(0, length - 1)
    hi = (lo + 1).clamp(0, length - 1)
    shape = [1] * x.dim()
    shape[axis] = -1
    w = (pos - floor).to(x.dtype).reshape(shape)
    return x.index_select(axis, lo) * (1 - w) + x.index_select(axis, hi) * w


def sample_embedding(emb: torch.Tensor, coord: torch.Tensor,
                     reduction_factor: float,
                     jitter: Optional[Sequence[int]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear subsample of ``emb`` ``[B, H, W, D, C]`` and ``coord``
    ``[B, H, W, D, 3]`` to the reduced grid; returns ``([B, N', C],
    [B, N', 3])``.  ``jitter``: front/back crop per axis."""
    spatial = emb.shape[1:4]
    reduced = [max(int(s // reduction_factor), 1) for s in spatial]
    js = [0] * 6 if jitter is None else [int(j) for j in jitter]
    for ax in range(3):
        pos = _axis_positions(spatial[ax], reduced[ax], js[2 * ax],
                              js[2 * ax + 1], emb.device)
        emb = _gather_lerp(emb, pos, 1 + ax)
        coord = _gather_lerp(coord, pos, 1 + ax)
    b = emb.shape[0]
    return emb.reshape(b, -1, emb.shape[-1]), coord.reshape(b, -1, 3)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True) \
        .clamp_min(1e-12)


def _pos_weights(coord_x: torch.Tensor, coord_y: torch.Tensor,
                 fwhm: float) -> torch.Tensor:
    """Gaussian position weights ``exp(-d^2 / 2 sigma^2)``, ``[B, N1, N2]``."""
    diff = coord_x[:, :, None, :] - coord_y[:, None, :, :]
    dist2 = (diff * diff).sum(-1)
    sigma_sq = (fwhm / 2.355) ** 2
    return torch.exp(-dist2 / (2.0 * sigma_sq))


def _closest(coord_x: torch.Tensor, coord_y: torch.Tensor,
             max_dist: float = 4.0):
    """(index of the nearest ``coord_y`` point, nearest within
    ``max_dist``) for every ``coord_x`` point; ties take the first."""
    diff = coord_x[:, :, None, :] - coord_y[:, None, :, :]
    dist = torch.sqrt((diff * diff).sum(-1))
    return torch.argmin(dist, -1), dist.amin(-1) <= max_dist


def cluster_prototype(emb_p: torch.Tensor, coord_p: torch.Tensor,
                      emb_t: torch.Tensor, coord_t: torch.Tensor,
                      n_iter: int, temp: float, fwhm: float):
    """Soft k-means with Gaussian position weighting; returns the
    prototypes' embeddings and coordinates and the teacher points'
    weighted assignment ``[B, N, P]``."""
    emb_p_n = _normalize(emb_p)
    emb_t_n = _normalize(emb_t)
    for _ in range(n_iter):
        sim_soft = torch.softmax(
            torch.einsum("bnc,bpc->bnp", emb_t_n, emb_p_n) / temp, dim=-1)
        sim_weighted = sim_soft * _pos_weights(coord_t, coord_p, fwhm)
        denom = sim_weighted.sum(1)[..., None]                # [B, P, 1]
        emb_p = torch.einsum("bnp,bnc->bpc", sim_weighted, emb_t) / denom
        emb_p_n = _normalize(emb_p)
        coord_p = torch.einsum("bnp,bnc->bpc", sim_weighted, coord_t) / denom
    sim_soft = torch.softmax(
        torch.einsum("bnc,bpc->bnp", emb_t_n, emb_p_n) / temp, dim=-1)
    return emb_p, coord_p, sim_soft * _pos_weights(coord_t, coord_p, fwhm)


def assign_prototype(emb_z: torch.Tensor, coord_z: torch.Tensor,
                     emb_t: torch.Tensor, coord_t: torch.Tensor,
                     emb_p: torch.Tensor, sim_t_p: torch.Tensor,
                     temp: float) -> torch.Tensor:
    """Per-sample clustered cross-entropy ``[B]`` of the student points
    against their nearest teacher point's assignment."""
    emb_z_n = _normalize(emb_z)
    emb_p_n = _normalize(emb_p)
    idx_closest, mask = _closest(coord_z, coord_t)                # [B, M]
    sim_soft = torch.softmax(
        torch.einsum("bmc,bpc->bmp", emb_z_n, emb_p_n) / temp, dim=-1)
    assignment = torch.gather(
        sim_t_p, 1, idx_closest[..., None].expand(-1, -1, sim_t_p.shape[-1]))
    # min/max (not clamp): a value on a bound splits its gradient between
    # the two sides, as jnp.clip's does.
    log_sim = torch.log(sim_soft + 1e-16)
    log_sim = torch.minimum(torch.maximum(log_sim, log_sim.new_tensor(-1e3)),
                            log_sim.new_tensor(0.0))
    ce = -(assignment * log_sim).sum(-1)                          # [B, M]
    maskf = mask.to(ce.dtype)
    return (ce * maskf).sum(1) / maskf.sum(1).clamp_min(1.0)


def clustered_prototype_loss(
        emb_s: List[torch.Tensor], emb_t: torch.Tensor,
        coord_s: List[torch.Tensor], coord_t: torch.Tensor,
        jitters: Sequence[Sequence[int]],
        reduction_factor: float = 8.0,
        k_means_iterations: int = 3,
        fwhm: float = 128.0,
        temp_s: float = 0.066,
        temp_t: float = 0.033, group=None) -> torch.Tensor:
    """The phase-2 loss: the sum over students of the mean per-sample
    clustered cross-entropy; ``jitters[i]`` is student ``i``'s jitter.
    The caller detaches the teacher's ``emb_t``.  ``group`` (a
    ``parallel/mesh.py::DataGroup``): the samples are this rank's rows,
    each mean is over the global batch (this rank's share)."""
    if len(jitters) != len(emb_s):
        raise ValueError(f"{len(emb_s)} students, {len(jitters)} jitters")
    emb_p0, coord_p0 = sample_embedding(emb_t, coord_t, reduction_factor * 2)
    emb_t_s, coord_t_s = sample_embedding(emb_t, coord_t, reduction_factor)
    emb_p, _, sim_t_p = cluster_prototype(
        emb_p0, coord_p0, emb_t_s, coord_t_s, k_means_iterations, temp_t,
        fwhm)
    total = emb_t.new_zeros(())
    for es, cs, jitter in zip(emb_s, coord_s, jitters):
        es_s, cs_s = sample_embedding(es, cs, reduction_factor, jitter)
        per_b = assign_prototype(es_s, cs_s, emb_t_s, coord_t_s, emb_p,
                                 sim_t_p, temp_s)
        total = total + (per_b.mean() if group is None or not group.splits
                         else per_b.sum() / group.sum(
                             per_b.new_tensor(float(len(per_b)))))
    return total
