"""Slice-wise serving of a box-prompted MedSAM study on the device.

A study is an int16 volume ``[H, W, D]`` (or ``[H, W, D, 1]``) and one
3D box ``(x0, y0, x1, y1, z0, z1)`` in voxels: the 2D box ``(x0, y0, x1,
y1)`` on every slice ``z0 <= z < z1``, x along the slice's columns (axis
1), y along its rows (axis 0).  :class:`SamSlices` runs MedSAM's slice
protocol (``MedSAM_Inference.py``) over the box's slices:

1. the raw volume is uploaded and the box's slices windowed on the
   device (``preprocess``: the config's ``hu_window``, scaled to [0, 1]);
2. each slice resized to the encoder's 1024^2 (bicubic) and min-max
   normalised;
3. the image encoder over batches of ``slice_batch`` slices, then the
   prompt encoder and the mask decoder over all the study's slices at
   once, one box each (the box scaled from the slice to 1024: ``box /
   [W, H, W, H] * 1024``);
4. ``sigmoid`` of the low-res logits, a bilinear resize to ``[H, W]``, a
   threshold at 0.5, the masks written into a uint8 label volume that is
   0 outside the box's slices.

Two departures from MedSAM's host preprocessing (``configurations/
medsam_vit_b.yml`` notes them too): the resize is torch's bicubic where
MedSAM calls skimage's order-3 spline (and rounds the resized slice to
uint8), and the window is taken on the device from the raw upload.

A call's steps are spans of ``utils/trace.py`` inside the caller's
``serve.volume`` unit: ``serve.upload``, ``serve.preprocess``,
``serve.sam.encoder`` (one per slice batch), ``serve.sam.prompt``,
``serve.sam.decoder`` and ``serve.sam.postprocess``; counters
``serve.sam.slices``, ``serve.sam.prompts`` and
``serve.sam.encoder_batches``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.sam import Sam
from ..utils import trace


def check_box(box: Sequence[int], shape: Sequence[int]
              ) -> Tuple[int, ...]:
    """``box`` as six ints, raising unless it lies inside a volume of
    ``shape`` ``[H, W, D]`` with positive sides."""
    if len(box) != 6:
        raise ValueError(f"a box is (x0, y0, x1, y1, z0, z1), got {box!r}")
    x0, y0, x1, y1, z0, z1 = (int(v) for v in box)
    h, w, d = shape[:3]
    if not (0 <= x0 < x1 <= w and 0 <= y0 < y1 <= h and 0 <= z0 < z1 <= d):
        raise ValueError(f"box {tuple(box)} does not lie inside a volume "
                         f"of {h}x{w}x{d} (x < {w}, y < {h}, z < {d})")
    return x0, y0, x1, y1, z0, z1


class SamSlices:
    """The serving runner of a :class:`Sam` model (put in eval mode here):
    ``runner(volume, box)`` queues one study's device work and returns
    its uint8 label volume ``[H, W, D]`` on the device."""

    def __init__(self, model: Sam, preprocess: Callable, device):
        self.model = model.eval()
        self.conf = model.conf
        self.preprocess = preprocess
        self.device = device
        self.group = None       # no data group: one card serves a study
        self._shapes = set()

    @property
    def n_buckets(self) -> int:
        """Distinct (volume shape, slice count) pairs served so far."""
        return len(self._shapes)

    def box_image(self, box: Tuple[int, ...], hw) -> torch.Tensor:
        """The 2D box in the encoder's image pixels, ``[1, 4]`` float32 on
        the device (uploaded without waiting for the card)."""
        h, w = hw
        size = self.conf.image_size
        scaled = [box[0] / w * size, box[1] / h * size, box[2] / w * size,
                  box[3] / h * size]
        return torch.tensor([scaled], dtype=torch.float32).to(
            self.device, non_blocking=True)

    def images(self, vol: torch.Tensor, z0: int, z1: int) -> torch.Tensor:
        """The box's slices of the uploaded volume as the encoder's input
        ``[n, 1, S, S]`` in the compute dtype: windowed, resized (bicubic)
        and min-max normalised per slice."""
        size = self.conf.image_size
        x = self.preprocess(vol[:, :, z0:z1]).permute(2, 0, 1)[:, None]
        x = F.interpolate(x, size=(size, size), mode="bicubic",
                          align_corners=False)
        lo = x.amin(dim=(1, 2, 3), keepdim=True)
        hi = x.amax(dim=(1, 2, 3), keepdim=True)
        return ((x - lo) / (hi - lo).clamp_min(1e-8)).to(self.conf.dtype)

    def __call__(self, volume: np.ndarray, box: Sequence[int]
                 ) -> torch.Tensor:
        vol = np.asarray(volume)
        if vol.ndim == 4:
            vol = vol[..., 0]
        x0, y0, x1, y1, z0, z1 = box = check_box(box, vol.shape)
        h, w, d = vol.shape
        n = z1 - z0
        self._shapes.add((h, w, d, n))
        model = self.model
        with trace.span("serve.upload"):
            dev = torch.from_numpy(np.ascontiguousarray(vol)).to(
                self.device, non_blocking=True)
        with trace.span("serve.preprocess"):
            images = self.images(dev, z0, z1)
        trace.count("serve.sam.slices", n)
        trace.count("serve.sam.prompts", n)
        step = self.conf.slice_batch
        emb = []
        for s in range(0, n, step):
            with trace.span("serve.sam.encoder"):
                emb.append(model.image_encoder(images[s:s + step]))
            trace.count("serve.sam.encoder_batches")
        emb = emb[0] if len(emb) == 1 else torch.cat(emb)
        with trace.span("serve.sam.prompt"):
            boxes = self.box_image(box, (h, w)).expand(n, -1)
            sparse, dense = model.prompt_encoder(boxes)
            pe = model.prompt_encoder.get_dense_pe()
        with trace.span("serve.sam.decoder"):
            logits = model.mask_decoder(emb, pe, sparse, dense)[0]
        with trace.span("serve.sam.postprocess"):
            probs = F.interpolate(torch.sigmoid(logits.float()), size=(h, w),
                                  mode="bilinear", align_corners=False)
            labels = torch.zeros((h, w, d), dtype=torch.uint8,
                                 device=self.device)
            labels[:, :, z0:z1] = (probs[:, 0] > 0.5).permute(1, 2, 0)
        return labels
