from .multi_view import MultiViewTrainer
from .segmentation import SegmentationTrainer
from .students_teacher import StudentsTeacherTrainer

__all__ = ["MultiViewTrainer", "SegmentationTrainer",
           "StudentsTeacherTrainer"]
