"""Point-cloud ops of the port (counterpart of ``papc_tpu.ops``)."""

from papc_tpu_torch.ops.geometry import index_points, square_distance
from papc_tpu_torch.ops.grouping import (
    knn,
    query_ball_point,
    sample_and_group,
    sample_and_group_all,
)
from papc_tpu_torch.ops.interpolate import three_nn_interpolate
from papc_tpu_torch.ops.sampling import farthest_point_sample

__all__ = [
    "farthest_point_sample",
    "index_points",
    "knn",
    "query_ball_point",
    "sample_and_group",
    "sample_and_group_all",
    "square_distance",
    "three_nn_interpolate",
]
