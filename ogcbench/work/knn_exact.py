"""#2, exact KNN: the pairs inside the cube of each query's k-th distance
(what a spatially pruned search must test), 8 operations a pair; queries,
points and the (dist, idx) lists moved once."""

from ogcbench.work._rules import D2_OPS, box_pairs, nbytes

TARGET = ("ogc_tpu_torch.ops.knn", "knn_exact")
KERNELS = ("knn_exact_kernel", "knn_warp_kernel")


def work(args, kwargs, out):
    query, points = args[0], args[1]
    dist, idx = out
    pairs = box_pairs(query, points, dist[..., -1])
    return D2_OPS * pairs, nbytes(query, points, dist, idx), "f32"
