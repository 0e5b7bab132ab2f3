"""A cell's specification cut to a size the CPU runs in seconds: few
points, small batches, few distinct batches."""

import copy

from ogcbench import run


def tiny_spec(workload: str, n: int = 1024, batch: int = 2,
              batches: int = 3, spec: dict = None) -> dict:
    spec = copy.deepcopy(spec or run.resolve(workload))
    spec["traffic"].update(batch=batch, batches=batches, n_points=n,
                           trace_steps=2)
    cfg = spec["cfg"]
    cfg["segnet" if "segnet" in cfg else "flownet"][
        "n_point" if "segnet" in cfg else "npoint"] = n
    return spec
