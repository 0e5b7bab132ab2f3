from ogc_tpu_torch.ops.core import (
    exact_neighbors,
    furthest_point_sample,
    gather,
    group,
    group_with_idx,
    interpolate_weights,
    knn,
    query_and_group,
    set_exact_neighbors,
    three_interpolate,
    three_nn,
    upsample_feat,
)

__all__ = [
    "exact_neighbors",
    "furthest_point_sample",
    "gather",
    "group",
    "group_with_idx",
    "interpolate_weights",
    "knn",
    "query_and_group",
    "set_exact_neighbors",
    "three_interpolate",
    "three_nn",
    "upsample_feat",
]
