"""OGC-DR / OGC-DRSV dynamic-room datasets (copy of ogc_tpu/data/ogcdr.py).

Parity with reference datasets/dataset_ogcdr.py: per-scene directories of
pc_%02d.npy / segm_%02d.npy / pose_%02d.npy, GT flow computed from per-object
pose changes (foreground object ids start at 1).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import List, Optional

import numpy as np

from ogc_tpu_torch.data.base import PairFrameDataset


def compute_flow(
    pc1: np.ndarray, segm1: np.ndarray, pose1: np.ndarray, pose2: np.ndarray
) -> np.ndarray:
    """Flow from object pose change (dataset_ogcdr.py:10-27)."""
    flow = np.zeros_like(pc1)
    for k in range(pose1.shape[0]):
        rel = pose2[k] @ np.linalg.inv(pose1[k])
        sel = segm1 == (k + 1)
        flow[sel] = pc1[sel] @ rel[:3, :3].T + rel[:3, 3] - pc1[sel]
    return flow


class OGCDynamicRoomDataset(PairFrameDataset):
    def __init__(
        self,
        data_root: str,
        split: str = "train",
        view_sels: List[List[int]] = [[0, 1]],
        predflow_path: Optional[str] = None,
        decentralize: bool = False,
        aug_transform: bool = False,
        aug_transform_args: Optional[dict] = None,
        onehot_label: bool = False,
        max_n_object: int = 8,
    ):
        self.data_root = osp.join(data_root, "data")
        self.split = split
        with open(osp.join(self.data_root, split + ".lst")) as f:
            self.data_ids = f.read().strip().split("\n")
        self.view_sels = view_sels

        if predflow_path is not None:
            self.predflow_path = osp.join(data_root, "flow_preds", predflow_path)
            with open(self.predflow_path + ".json") as f:
                self.pf_view_sels = json.load(f)["view_sel"]
            if any(sel not in self.pf_view_sels for sel in view_sels):
                raise ValueError(
                    "Flow predictions cannot cover specified view selections!"
                )
            print("Load flow predictions from", self.predflow_path)
        else:
            self.predflow_path = None

        self.decentralize = decentralize
        self.aug_transform = aug_transform
        self.aug_transform_args = aug_transform_args
        self.onehot_label = onehot_label
        self.max_n_object = max_n_object
        self.ignore_npoint_thresh = 0

    def _load_item(self, idx, view_sel):
        data_path = osp.join(self.data_root, self.data_ids[idx])
        pcs, segms, poses = [], [], []
        for view in view_sel:
            pcs.append(np.load(osp.join(data_path, "pc_%02d.npy" % view)))
            segms.append(np.load(osp.join(data_path, "segm_%02d.npy" % view)))
            poses.append(np.load(osp.join(data_path, "pose_%02d.npy" % view)))

        if self.predflow_path is not None:
            v1, v2 = view_sel
            flow_pred = np.load(
                osp.join(self.predflow_path, self.data_ids[idx] + ".npy")
            )
            flows = [
                flow_pred[self.pf_view_sels.index([v1, v2])],
                flow_pred[self.pf_view_sels.index([v2, v1])],
            ]
        else:
            flows = [
                compute_flow(pcs[0], segms[0], poses[0], poses[1]),
                compute_flow(pcs[1], segms[1], poses[1], poses[0]),
            ]
        return np.stack(pcs, 0), np.stack(segms, 0), np.stack(flows, 0)

    def _save_predflow(self, flow_pred, save_root, batch_size, n_frame=1, offset=0):
        flow_pred = np.asarray(flow_pred)
        for sid in range(flow_pred.shape[0] // n_frame):
            save_flow = flow_pred[sid * n_frame : (sid + 1) * n_frame]
            idx = offset * batch_size // n_frame + sid
            np.save(osp.join(save_root, self.data_ids[idx] + ".npy"), save_flow)

    def _save_predsegm(self, mask, save_root, batch_size, n_frame=1, offset=0):
        mask = np.asarray(mask)
        for sid in range(mask.shape[0]):
            segm_pred = mask[sid].argmax(1)
            gid = offset * batch_size + sid
            idx, vi = gid // n_frame, gid % n_frame
            save_path = os.path.join(save_root, self.data_ids[idx])
            os.makedirs(save_path, exist_ok=True)
            np.save(os.path.join(save_path, "segm_%02d.npy" % vi), segm_pred)
