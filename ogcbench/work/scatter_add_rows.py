"""#11, the deterministic row scatter-add (B, R) x (B, R, C) -> (B, n, C):
one add a source element; destinations, rows and sums moved once."""

from ogcbench.work._rules import nbytes

TARGET = ("ogc_tpu_torch.ops.scatter", "scatter_add_rows")
KERNELS = ("csr_count_kernel", "csr_scan_kernel", "csr_place_kernel",
           "accumulate_warp_kernel", "accumulate_thread_kernel")


def work(args, kwargs, out):
    idx, g = args[0], args[1]
    return float(g.numel()), nbytes(idx, g, out), "f32"
