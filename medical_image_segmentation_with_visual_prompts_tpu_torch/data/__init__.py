from .datasets import (DataLoader, Dataset, get_fit_loader_downstream,
                       get_test_loader_downstream)
from .nifti import load_nifti, save_nifti
from .transforms import (load_image, load_image_raw, load_served,
                         orient_ras, scale_intensity_range,
                         transform_downstream_fit, transform_downstream_test,
                         write_labels)

__all__ = ["DataLoader", "Dataset", "get_fit_loader_downstream",
           "get_test_loader_downstream", "transform_downstream_test",
           "load_image", "load_image_raw", "load_nifti", "load_served",
           "orient_ras", "save_nifti", "scale_intensity_range",
           "transform_downstream_fit", "write_labels"]
