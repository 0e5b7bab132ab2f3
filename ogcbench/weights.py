"""Seeded weights, made on the device in two large draws and cut into the
reference's parameters by name, in the type they are served in (float32).

Products' weights are normal with std sqrt(2 / fan_in) for 1x1 convs and
1 / sqrt(fan_in) for linears; norm scales 1 + 0.1 z and shifts 0.1 z;
biases 0.1 z; slot queries unit normal; BatchNorm running means 0.1 z and
running variances uniform in [0.5, 1.5]; FlowStep3D's correlation epsilon
0.1 z, and its flow heads (``*regressor.fc``) drawn ``FLOW_HEAD`` times
smaller, so that the flows are of KITTI-SF's scale (about a metre) and the
refinement searches a warped cloud that lies where a trained model's
would.  The program and the reference are given the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

FLOW_HEAD = 0.1


def make(shapes: Dict[str, Tuple[int, ...]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [math.prod(s) for s in shapes.values()]
    total = sum(sizes)
    z = torch.randn(total, generator=gen, device=device)
    u = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        zs, us = z[off:off + n].reshape(shape), u[off:off + n].reshape(shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        elif leaf == "running_var":
            t = 0.5 + us
        elif leaf in ("running_mean", "epsilon") or leaf.endswith("bias"):
            t = 0.1 * zs
        elif name.endswith("query.weight"):
            t = zs
        elif len(shape) >= 2:
            fan_in = math.prod(shape[1:])
            conv = len(shape) > 2 or "conv" in name
            t = zs * (math.sqrt(2.0 / fan_in) if conv
                      else 1.0 / math.sqrt(fan_in))
            if name.endswith("regressor.fc.weight"):
                t = t * FLOW_HEAD
        else:  # norm scales
            t = 1.0 + 0.1 * zs
        out[name] = t.contiguous()
    return out
