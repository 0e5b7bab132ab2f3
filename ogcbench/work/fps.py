"""#1, greedy furthest point sampling: (npoint - 1) sequential steps, each
a d2 against the last pick and a running minimum per point (9 f32
operations a point); the cloud read once, the indices written once."""

from ogcbench.work._rules import nbytes

TARGET = ("ogc_tpu_torch.ops.fps", "fps")
KERNELS = ("fps_kernel",)


def work(args, kwargs, out):
    xyz, npoint = args[0], args[1]
    B, N, _ = xyz.shape
    return 9.0 * B * N * max(npoint - 1, 0), nbytes(xyz, out), "f32"
