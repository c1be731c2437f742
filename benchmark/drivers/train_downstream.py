"""Downstream prompt-tuning driver: one
``SegmentationTrainer.train_step(batch)`` per step on a batch of
``batch`` crops with label maps.  See ``benchmark/training.py``.

Traffic keys: ``batch`` (crops per step), ``pool`` (host batches,
cycled), ``follow`` (first steps that the reference follows),
``trace_units`` (steps under the profiler in a traced run), ``limits``.
"""

from __future__ import annotations

from benchmark import training


def job(cell) -> training.Job:
    from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
        import segmentation
    return training.Job(cell, segmentation.SegmentationTrainer, views=1,
                        labels=True)


def run(cell):
    return training.run(job(cell))


def control(cell) -> dict:
    return training.control(job(cell))
