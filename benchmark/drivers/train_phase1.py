"""Phase-1 multi-view pretraining driver: one
``MultiViewTrainer.train_step(batch, draws)`` per step, two views of each
batch of ``batch`` crops, the draws (rotations, mask ranks, no axis swap)
from the benchmark's seeded generator.  See ``benchmark/training.py``.

Traffic keys: ``batch`` (crops per step), ``pool`` (host batches,
cycled), ``follow`` (first steps that the reference follows),
``trace_units`` (steps under the profiler in a traced run), ``limits``.
"""

from __future__ import annotations

from benchmark import training


def job(cell) -> training.Job:
    from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
        import multi_view
    return training.Job(cell, multi_view.MultiViewTrainer, views=2,
                        labels=False)


def run(cell):
    return training.run(job(cell))


def control(cell) -> dict:
    return training.control(job(cell))
