"""Flow extraction through kernel #12, the row-group pool: ``test_flow``'s
eval forward with ``OGC_PALLAS_POOL=on`` (``ops.set_pool_mode("on")``), so
that every eval neighbour pool the gate admits runs ``csrc/pool.cu``
(CUDA tensors; on the CPU the gate keeps the plain chain).  Otherwise the
``flow_infer`` cell unchanged: the same forward, traffic, reference and
limits.  ``free`` gives the pool back the mode the environment sets."""

from __future__ import annotations

import os

import torch

from ogcbench.drivers import flow_infer


class Cell(flow_infer.Cell):
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        from ogc_tpu_torch import ops

        ops.set_pool_mode("on")
        super().__init__(cfg, traffic, seed, device)

    def free(self) -> None:
        from ogc_tpu_torch import ops

        super().free()
        ops.set_pool_mode(os.environ.get("OGC_PALLAS_POOL", "off"))
