from .distributed import (maybe_initialize_distributed, masked_mean,
                          stage_global_batch)
from .mesh import DataGroup, make_mesh, replicate, shard_batch
from .sliding_window import (BucketedInference, bucket_shape, bucketed_starts,
                             cover_shape, gaussian_importance,
                             gaussian_weight_acc, resolve_stride,
                             window_starts)
from .train_parallel import (data_parallel, make_dp_serving_step,
                             make_dp_train_step)

__all__ = ["BucketedInference", "DataGroup", "bucket_shape",
           "bucketed_starts", "cover_shape", "data_parallel",
           "gaussian_importance", "gaussian_weight_acc", "make_dp_serving_step",
           "make_dp_train_step", "make_mesh", "masked_mean",
           "maybe_initialize_distributed", "replicate", "resolve_stride",
           "shard_batch", "stage_global_batch", "window_starts"]
