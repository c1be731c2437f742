"""Training-view ops: rotation, masking, permutation, label remapping.

Counterpart of the JAX package's ``ops/augment.py``.  Its two random ops
(``random_rotate``, ``random_mask``) are split into a draw (from a
``torch.Generator``, on the host) and an application, so that a caller
can pass any draws, the JAX step's among them (``jax.random`` draws
cannot be reproduced in torch):

* :func:`draw_rotations` / :func:`rotate_by` -- a per-sample rotation by
  ``k`` x 90 degrees (``k`` in 0-3, the rotation class) in the H-W plane
  (``H == W``), the way ``jnp.rot90(x, k, axes=(1, 2))`` turns;
* :func:`align_rotation` -- undo and/or apply per-sample rotations;
* :func:`draw_mask_rank` / :func:`mask_by` -- exact-count patchwise
  masking, shared by the batch: ``rank`` is a permutation of the patch
  indices and the patches of rank ``>= round(n * (1 - ratio))`` are
  masked (zeroed); returns the keep-mask;
* :func:`random_permute` / :func:`permute_inverse` -- one of three
  spatial axis swaps (involutions);
* :func:`map_label_indices`.

Layout: channels-last ``[B, H, W, D, C]``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_PERMUTATIONS = ((0, 2, 1, 3, 4), (0, 3, 2, 1, 4), (0, 1, 3, 2, 4))


def draw_rotations(gen: torch.Generator, b: int) -> torch.Tensor:
    """``b`` rotation classes in 0-3 (int64, on the host)."""
    return torch.randint(0, 4, (b,), generator=gen)


def rotate_by(x: torch.Tensor, ks, invert: bool = False) -> torch.Tensor:
    """Rotate sample ``i`` by ``ks[i]`` x 90 degrees in the H-W plane
    (back, with ``invert``)."""
    ks = [int(k) for k in torch.as_tensor(ks).reshape(-1).tolist()]
    if len(ks) != x.shape[0]:
        raise ValueError(f"{len(ks)} rotations for a batch of {x.shape[0]}")
    if x.shape[1] != x.shape[2]:
        raise ValueError(f"rotation in the H-W plane needs H == W, got "
                         f"{tuple(x.shape[1:3])}")
    sign = -1 if invert else 1
    return torch.stack([torch.rot90(x[i], sign * k, dims=(0, 1))
                        for i, k in enumerate(ks)])


def align_rotation(x: torch.Tensor, src_rot=None, dst_rot=None
                   ) -> torch.Tensor:
    """Rotate back by ``src_rot`` and/or forward by ``dst_rot``."""
    if src_rot is None and dst_rot is None:
        raise ValueError("src_rot or dst_rot is None!")
    if src_rot is not None:
        x = rotate_by(x, src_rot, invert=True)
    if dst_rot is not None:
        x = rotate_by(x, dst_rot)
    return x


def mask_shape(input_size: Sequence[int], patch_size: Sequence[int]
               ) -> Tuple[int, ...]:
    """Patches per axis; the sizes must divide."""
    if any(s0 % s1 != 0 for s0, s1 in zip(input_size, patch_size)):
        raise ValueError(
            f"Input size {tuple(input_size)} and patch size "
            f"{tuple(patch_size)} is not compatible!")
    return tuple(s0 // s1 for s0, s1 in zip(input_size, patch_size))


def draw_mask_rank(gen: torch.Generator, n_patches: int) -> torch.Tensor:
    """A permutation of the ``n_patches`` patch indices (host int64)."""
    return torch.randperm(n_patches, generator=gen)


def mask_by(x: torch.Tensor, rank, input_size: Sequence[int],
            patch_size: Sequence[int], masking_ratio: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x with the masked patches zeroed, keep-mask ``[H, W, D]`` bool):
    ``round(n * (1 - ratio))`` patches (Python's ``round``) are kept, those
    whose ``rank`` is below that count."""
    shape = mask_shape(input_size, patch_size)
    n_patches = int(np.prod(shape))
    rank = torch.as_tensor(rank).reshape(-1).to(x.device)
    if rank.numel() != n_patches:
        raise ValueError(f"{rank.numel()} ranks for {n_patches} patches")
    keep = round(n_patches * (1 - masking_ratio))
    masked = (rank >= keep).reshape(shape)        # True = masked
    for ax, rep in enumerate(patch_size):
        masked = masked.repeat_interleave(int(rep), dim=ax)
    x_masked = torch.where(masked[None, ..., None], torch.zeros_like(x), x)
    return x_masked, ~masked


def random_permute(x: torch.Tensor, choice: int) -> torch.Tensor:
    """One of three spatial axis swaps: H-W, H-D or W-D."""
    return x.permute(*_PERMUTATIONS[choice])


def permute_inverse(x: torch.Tensor, choice: int) -> torch.Tensor:
    """The inverse of :func:`random_permute` (each swap is its own)."""
    return x.permute(*_PERMUTATIONS[choice])


def permuted_shape(shape: Sequence[int], choice: int) -> Tuple[int, ...]:
    """The ``[H, W, D]`` shape after :func:`random_permute`'s swap."""
    return tuple(shape[a - 1] for a in _PERMUTATIONS[choice][1:4])


def map_label_indices(masks: torch.Tensor,
                      active_labels: Sequence[int]) -> torch.Tensor:
    """Keep the active labels, zero the others, and renumber the active
    ones 0..K-1 in sorted order."""
    out = torch.zeros_like(masks)
    for new, lbl in enumerate(sorted(int(v) for v in active_labels)):
        out = torch.where(masks == float(lbl),
                          torch.full_like(masks, float(new)), out)
    return out
