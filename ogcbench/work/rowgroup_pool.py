"""#12, the neighbour pool (R, C) -> (R / s, C): a scale, an add, the
ReLU and the reduce, up to 4 operations an input element; input, scale,
add and output moved once."""

from ogcbench.work._rules import nbytes

TARGET = ("ogc_tpu_torch.ops.pool", "rowgroup_pool")
KERNELS = ("rowgroup_pool_kernel",)


def work(args, kwargs, out):
    x, scale, add = args[0], args[1], args[2]
    ops = 1 + (scale is not None) + (add is not None) \
        + bool(kwargs.get("relu", True))
    return float(ops * x.numel()), nbytes(x, scale, add, out), "f32"
