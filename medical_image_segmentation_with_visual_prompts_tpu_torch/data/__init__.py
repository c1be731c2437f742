from .datasets import (DataLoader, Dataset, batch_size_of,
                       get_fit_loader_downstream,
                       get_fit_loader_self_supervised_learning,
                       get_fit_loader_supervised_learning,
                       get_test_loader_downstream, num_samples_of)
from .nifti import load_nifti, save_nifti
from .transforms import (get_coord_grid, load_image, load_image_raw,
                         load_served, orient_ras, scale_intensity_range,
                         transform_downstream_fit, transform_downstream_test,
                         transform_pretrain_fit, write_labels)

__all__ = ["DataLoader", "Dataset", "batch_size_of", "get_coord_grid",
           "get_fit_loader_downstream",
           "get_fit_loader_self_supervised_learning",
           "get_fit_loader_supervised_learning",
           "get_test_loader_downstream", "transform_downstream_test",
           "load_image", "load_image_raw", "load_nifti", "load_served",
           "num_samples_of", "orient_ras", "save_nifti",
           "scale_intensity_range", "transform_downstream_fit",
           "transform_pretrain_fit", "write_labels"]
