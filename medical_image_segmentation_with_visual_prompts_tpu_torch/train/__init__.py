from .segmentation import SegmentationTrainer
from .students_teacher import StudentsTeacherTrainer

__all__ = ["SegmentationTrainer", "StudentsTeacherTrainer"]
