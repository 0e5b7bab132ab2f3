"""#8, the small-source scatter-add: as #11."""

from ogcbench.work._rules import nbytes

TARGET = ("ogc_tpu_torch.ops.onehot", "scatter_add_rows_onehot")
KERNELS = ("scatter_rows_kernel",)


def work(args, kwargs, out):
    idx, g = args[0], args[1]
    return float(g.numel()), nbytes(idx, g, out), "f32"
