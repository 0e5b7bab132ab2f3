"""#5, exact ball query (the nsample lowest in-radius indices): the pairs
inside the cube of half-width r around each centre, up to the ball's last
member's index; points, centres and the ball moved once."""

import torch

from ogcbench.work._rules import D2_OPS, box_pairs, nbytes

TARGET = ("ogc_tpu_torch.ops.ball", "ball_query_exact")
KERNELS = ("ball_kernel<1>",)


def work(args, kwargs, out):
    xyz, new_xyz, radius = args[0], args[1], args[2]
    half = torch.full(new_xyz.shape[:2], float(radius),
                      device=new_xyz.device)
    pairs = box_pairs(new_xyz, xyz, half, out.amax(-1))
    return D2_OPS * pairs, nbytes(xyz, new_xyz, out), "f32"
