"""The FlowStep3D evaluation protocol on KITTI (the kitti142 split, numpy
seed 18) with the PyTorch port: FlowStep3D's own flow on the protocol's
points, and the saved (OA-ICP refined) flow interpolated onto them.

Usage (the flags of the repo's test_flow_kittisf_benchmark.py):
    python -m ogc_tpu_torch.test_flow_kittisf_benchmark \\
        config/flow/kittisf/kittisf_unsup.yaml [--approx_knn] [--device cuda]

Reads ``<root>`` (full resolution) and ``<root>_downsampled`` with the
predictions ``flowstep3d_for-benchmark_R2``; weights from the config's
``save_path``.  The protocol's random sampling draws from numpy's global
generator in the JAX CLI's order, so the same seed keeps the same points.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from ogc_tpu_torch import ops
from ogc_tpu_torch.data.kittisf import KITTISceneFlowDataset
from ogc_tpu_torch.metrics.flow import eval_flow
from ogc_tpu_torch.outdoor import METRICS, OutdoorFlow
from ogc_tpu_torch.utils.config import load_config_into_args
from ogc_tpu_torch.utils.meters import AverageMeter

# The protocol: 8192 points drawn a frame, 5 flownet iterations (as the
# JAX CLI).
N_SAMPLE_POINT, N_ITERS = 8192, 5


def preproc(pc1, pc2, flow, remove_ground=False, n_sample_point=None):
    """FlowStep3D's preprocessing: ground removal + random sampling
    (reference test_flow_kittisf_benchmark.py:14-43)."""
    if remove_ground:
        is_ground = np.logical_and(pc1[:, 1] < -1.4, pc2[:, 1] < -1.4)
        not_ground = np.logical_not(is_ground)
        pc1, pc2 = pc1[not_ground], pc2[not_ground]
        flow = flow[not_ground]
    if n_sample_point is not None:
        n = pc1.shape[0]
        replace = n < n_sample_point
        idx1 = np.random.choice(n, size=n_sample_point, replace=replace)
        idx2 = np.random.choice(n, size=n_sample_point, replace=replace)
        pc1, pc2 = pc1[idx1], pc2[idx2]
        flow = flow[idx1]
    return pc1, pc2, flow


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Evaluate; print the JAX CLI's two reports and return them."""
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str, help="Config file")
    parser.add_argument("--approx_knn", default=False, action="store_true",
                        help="Approximate neighbour search")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model runs on")
    args = parser.parse_args(argv)
    load_config_into_args(args)
    args.test_model_iters = N_ITERS
    # Fixed seed matching the FlowStep3D protocol (reference :58-59).
    np.random.seed(18)
    dev = OutdoorFlow(args)

    data_root = args.data["root"]
    view_sels = [[0, 1], [1, 0]]
    mapping_path = "data_prepare/kittisf/splits/kitti142.txt"
    test_set = KITTISceneFlowDataset(
        data_root=data_root, mapping_path=mapping_path, downsampled=False,
        view_sels=view_sels)
    test_set_predflow = KITTISceneFlowDataset(
        data_root=data_root + "_downsampled", mapping_path=mapping_path,
        downsampled=True, view_sels=view_sels,
        predflow_path="flowstep3d_for-benchmark_R2")

    meter_fs3d, meter = AverageMeter(), AverageMeter()
    for sid in range(len(test_set) // 2):
        pcs_org, _, flows_org, _ = test_set[sid * 2]
        pcs, _, flow_preds, _ = test_set_predflow[sid * 2]
        pc1_org, pc2_org, flow_org = preproc(
            pcs_org[0], pcs_org[1], flows_org[0], remove_ground=True,
            n_sample_point=N_SAMPLE_POINT)
        p1, p2 = dev.tensor(pc1_org[None]), dev.tensor(pc2_org[None])
        with torch.no_grad():
            flow_fs3d = dev.net(p1, p2, p1, p2, dev.iters)[-1].cpu().numpy()
        meter_fs3d.append_loss(dict(zip(METRICS,
                                        eval_flow(flow_org[None], flow_fs3d))))

        # Interpolate the saved (OA-ICP refined) flow to the protocol points.
        pc, flow_pred = pcs[0], flow_preds[0]
        not_ground = np.logical_not(pc[:, 1] < -1.4)
        with torch.no_grad():
            flow_up = ops.upsample_feat(
                p1, dev.tensor(pc[not_ground][None]),
                dev.tensor(flow_pred[not_ground][None])).cpu().numpy()
        meter.append_loss(dict(zip(METRICS,
                                   eval_flow(flow_org[None], flow_up))))

    fs3d, ours = meter_fs3d.get_mean_loss_dict(), meter.get_mean_loss_dict()
    print("FlowStep3D:", fs3d)
    print("Ours:", ours)
    return {"FlowStep3D": fs3d, "Ours": ours}


if __name__ == "__main__":
    main()
