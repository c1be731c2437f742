"""Faults planted in the program underneath a run, for the checks that
``correct`` comes out false (``tests/test_portbench_faults.py`` on the
CPU, ``calibrate.py --fault`` on the card).  Each ``plant(name)`` patches
the program and returns the function that undoes it.

* ``altered_answer``: the label crop altered where it is produced (a
  corner block of labels flipped);
* ``half_windows``: half of each window chunk left out of the forward,
  its logits taken from the other half;
* ``unchanged_state``: the optimizer's step leaves the state as it was;
* ``half_batch``: the trainers step on half of the batch, the mean taken
  over the rest.
"""

from __future__ import annotations

import torch

SERVING = ("altered_answer", "half_windows")
TRAINING = ("unchanged_state", "half_batch")


def _patch(owner, name, new):
    old = getattr(owner, name)
    setattr(owner, name, new)
    return lambda: setattr(owner, name, old)


def plant(name: str):
    if name == "altered_answer":
        from medical_image_segmentation_with_visual_prompts_tpu_torch import \
            infer
        real = infer.predict_device

        def altered(runner, roi, volume):
            crop, slices = real(runner, roi, volume)
            crop = crop.clone()
            crop[:8, :8] = 1 - crop[:8, :8]
            return crop, slices
        return _patch(infer, "predict_device", altered)
    if name == "half_windows":
        from medical_image_segmentation_with_visual_prompts_tpu_torch.\
            parallel.sliding_window import BucketedInference
        real = BucketedInference._logits

        def half(self, vol, part):
            n = len(part)
            logits = real(self, vol, part[:(n + 1) // 2])
            return torch.cat([logits, logits[:n - len(logits)]])
        return _patch(BucketedInference, "_logits", half)
    if name == "unchanged_state":
        return _patch(torch.optim.AdamW, "step",
                      lambda self, closure=None: None)
    if name == "half_batch":
        from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
            import multi_view, segmentation
        real_seg = segmentation.SegmentationTrainer._staged
        real_mv = multi_view.MultiViewTrainer._image_and_draws

        def seg(self, batch):
            image, labels, weights = real_seg(self, batch)
            h = image.shape[0] // 2
            return image[:h], labels[:h], weights

        def mv(self, batch, draws):
            image, draws = real_mv(self, batch, draws)
            h = image.shape[0] // 2
            return image[:h], draws._replace(rot_i=draws.rot_i[:h],
                                             rot_j=draws.rot_j[:h])
        undo = [_patch(segmentation.SegmentationTrainer, "_staged", seg),
                _patch(multi_view.MultiViewTrainer, "_image_and_draws", mv)]
        return lambda: [u() for u in undo]
    raise KeyError(f"no fault {name!r}")
