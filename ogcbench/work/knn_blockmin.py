"""#3, block-min approximate KNN: as #2, the pairs inside the cube of each
query's k-th returned distance (runs outside it cannot place a winner)."""

from ogcbench.work._rules import D2_OPS, box_pairs, nbytes

TARGET = ("ogc_tpu_torch.ops.knn_blockmin", "knn_blockmin")
KERNELS = ("blockmin_thread_kernel", "blockmin_warp_kernel")


def work(args, kwargs, out):
    query, points = args[0], args[1]
    dist, idx = out
    pairs = box_pairs(query, points, dist[..., -1])
    return D2_OPS * pairs, nbytes(query, points, dist, idx), "f32"
