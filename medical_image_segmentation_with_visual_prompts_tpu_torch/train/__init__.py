from .segmentation import SegmentationTrainer

__all__ = ["SegmentationTrainer"]
