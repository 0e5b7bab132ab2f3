"""#7, the small-source row gather: no arithmetic; the source, indices
and rows moved once."""

from ogcbench.work._rules import nbytes

TARGET = ("ogc_tpu_torch.ops.onehot", "gather_rows_onehot")
KERNELS = ("gather_rows_kernel",)


def work(args, kwargs, out):
    src, idx = args[0], args[1]
    return 0.0, nbytes(src, idx, out), "f32"
