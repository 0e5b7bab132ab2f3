"""SAPIEN articulated-object dataset (MultiBodySync release layout); copy of
ogc_tpu/data/sapien.py.

Parity with reference datasets/dataset_sapien.py: items are .npz files with
`pc` (T,N,3), `segm` (T,N) and a `trans` dict of per-part/camera 4x4 pose
matrices; GT flow is computed analytically from pose changes.  SE(3) algebra
is done directly on 4x4 matrices (the reference routes through
pyquaternion-based Isometry, utils/sapien_util.py — numerically identical).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import List, Optional

import numpy as np

from ogc_tpu_torch.data.base import PairFrameDataset


def apply_se3(mat: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(4,4) @ (N,3) -> (N,3)."""
    return pts @ mat[:3, :3].T + mat[:3, 3]


def compute_flow(
    base_pc: np.ndarray,
    base_segms: np.ndarray,
    base_cam: np.ndarray,
    base_motions: List[np.ndarray],
    dest_cam: np.ndarray,
    dest_motions: List[np.ndarray],
) -> np.ndarray:
    """GT flow from per-part pose changes (dataset_sapien.py:11-19).

    flow = (dest_cam^-1 · dest_motion · base_motion^-1 · base_cam) @ p - p
    """
    final_pc = np.empty_like(base_pc)
    for part_id in range(len(base_motions)):
        sel = base_segms == (part_id + 1)
        M = (
            np.linalg.inv(dest_cam)
            @ dest_motions[part_id]
            @ np.linalg.inv(base_motions[part_id])
            @ base_cam
        )
        final_pc[sel] = apply_se3(M, base_pc[sel])
    return final_pc - base_pc


class SapienDataset(PairFrameDataset):
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
        with open(osp.join(data_root, "meta.json")) as f:
            self.meta = json.load(f)
        self.split = split
        self.data_ids = self.meta[split]
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

    def _load_data(self, idx):
        data = np.load(
            osp.join(self.data_root, "%06d.npz" % self.data_ids[idx]),
            allow_pickle=True,
        )
        return (
            data["pc"].astype(np.float32),
            data["segm"],
            data["trans"].item(),
        )

    def _load_predflow(self, idx):
        return np.load(osp.join(self.predflow_path, "%06d.npy" % self.data_ids[idx]))

    def _load_item(self, idx, view_sel):
        pcs, segms, trans = self._load_data(idx)
        n_parts = len(trans) - 1
        v1, v2 = view_sel
        pcs, segms = pcs[view_sel], segms[view_sel]

        def motions(view_id):
            return [np.asarray(trans[t][view_id]) for t in range(1, n_parts + 1)]

        if self.predflow_path is not None:
            flow_pred = self._load_predflow(idx)
            flows = [
                flow_pred[self.pf_view_sels.index([v1, v2])],
                flow_pred[self.pf_view_sels.index([v2, v1])],
            ]
        else:
            cam1 = np.asarray(trans["cam"][v1])
            cam2 = np.asarray(trans["cam"][v2])
            flows = [
                compute_flow(pcs[0], segms[0], cam1, motions(v1), cam2, motions(v2)),
                compute_flow(pcs[1], segms[1], cam2, motions(v2), cam1, motions(v1)),
            ]
        return pcs, segms, np.stack(flows, 0)

    def _save_predflow(self, flow_pred, save_root, batch_size, n_frame=1, offset=0):
        """flow_pred: (B, N, 3) array (dataset_sapien.py:145-155)."""
        flow_pred = np.asarray(flow_pred)
        for sid in range(flow_pred.shape[0] // n_frame):
            save_flow = flow_pred[sid * n_frame : (sid + 1) * n_frame]
            idx = offset * batch_size // n_frame + sid
            np.save(
                osp.join(save_root, "%06d.npy" % self.data_ids[idx]), save_flow
            )

    def _save_predsegm(self, mask, save_root, batch_size, n_frame=1, offset=0):
        """mask: (B, N, K) array (dataset_sapien.py:158-170)."""
        mask = np.asarray(mask)
        for sid in range(mask.shape[0]):
            segm_pred = mask[sid].argmax(1)
            gid = offset * batch_size + sid
            idx, vi = gid // n_frame, gid % n_frame
            save_path = os.path.join(save_root, "%06d" % self.data_ids[idx])
            os.makedirs(save_path, exist_ok=True)
            np.save(os.path.join(save_path, "segm_%02d.npy" % vi), segm_pred)
