"""KITTI Scene Flow dataset.

Parity with reference datasets/dataset_kittisf.py: per-scene directories of
pc{1,2}.npy (+ segm/flow in the downsampled 8192-pt version; full version has
one segm.npy and flow = pc2 - pc1).  Copy of ogc_tpu/data/kittisf.py that
reads with plain ``np.load`` (the JAX package's native batched reader gives
the same arrays).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import List, Optional

import numpy as np

from ogc_tpu_torch.data.base import PairFrameDataset


class KITTISceneFlowDataset(PairFrameDataset):
    def __init__(
        self,
        data_root: str,
        mapping_path: str,
        downsampled: bool = False,
        view_sels: List[List[int]] = [[0, 1]],
        predflow_path: Optional[str] = None,
        decentralize: bool = False,
        aug_transform: bool = False,
        aug_transform_args: Optional[dict] = None,
        onehot_label: bool = False,
        max_n_object: int = 15,
        ignore_npoint_thresh: int = 0,
    ):
        self.data_root = osp.join(
            data_root, "data" if downsampled else "processed"
        )
        with open(mapping_path) as f:
            self.data_ids = f.read().strip().split("\n")
        self.view_sels = view_sels

        if predflow_path is not None:
            self.predflow_path = osp.join(data_root, "flow_preds", predflow_path)
            print("Load flow predictions from", self.predflow_path)
        else:
            self.predflow_path = None

        self.downsampled = downsampled
        self.decentralize = decentralize
        self.aug_transform = aug_transform
        self.aug_transform_args = aug_transform_args
        self.onehot_label = onehot_label
        self.max_n_object = max_n_object
        self.ignore_npoint_thresh = ignore_npoint_thresh

    def _load_item(self, idx, view_sel):
        data_path = osp.join(self.data_root, self.data_ids[idx])
        v1, v2 = view_sel
        if self.downsampled:
            pc1 = np.load(osp.join(data_path, "pc%d.npy" % (v1 + 1)))
            pc2 = np.load(osp.join(data_path, "pc%d.npy" % (v2 + 1)))
            flow1 = np.load(osp.join(data_path, "flow%d.npy" % (v1 + 1)))
            flow2 = np.load(osp.join(data_path, "flow%d.npy" % (v2 + 1)))
            segm1 = np.load(osp.join(data_path, "segm%d.npy" % (v1 + 1)))
            segm2 = np.load(osp.join(data_path, "segm%d.npy" % (v2 + 1)))
        else:
            pc1 = np.load(osp.join(data_path, "pc%d.npy" % (v1 + 1)))
            pc2 = np.load(osp.join(data_path, "pc%d.npy" % (v2 + 1)))
            segm = np.load(osp.join(data_path, "segm.npy"))
            segm1, segm2 = segm, segm
            flow1, flow2 = pc2 - pc1, pc1 - pc2

        if self.predflow_path is not None:
            pf_path = osp.join(self.predflow_path, self.data_ids[idx])
            flow1 = np.load(osp.join(pf_path, "flow%d.npy" % (v1 + 1)))
            flow2 = np.load(osp.join(pf_path, "flow%d.npy" % (v2 + 1)))

        return (
            np.stack([pc1, pc2], 0),
            np.stack([segm1, segm2], 0),
            np.stack([flow1, flow2], 0),
        )

    def _save_predflow(self, flow_pred, save_root, batch_size, n_frame=1, offset=0):
        flow_pred = np.asarray(flow_pred)
        for sid in range(flow_pred.shape[0]):
            gid = offset * batch_size + sid
            idx, vi = gid // n_frame, gid % n_frame
            save_path = osp.join(save_root, self.data_ids[idx])
            os.makedirs(save_path, exist_ok=True)
            np.save(osp.join(save_path, "flow%d.npy" % (vi + 1)), flow_pred[sid])

    def _save_predsegm(self, mask, save_root, batch_size, n_frame=1, offset=0):
        mask = np.asarray(mask)
        for sid in range(mask.shape[0]):
            segm_pred = mask[sid].argmax(1)
            gid = offset * batch_size + sid
            idx, vi = gid // n_frame, gid % n_frame
            save_path = osp.join(save_root, self.data_ids[idx])
            os.makedirs(save_path, exist_ok=True)
            np.save(osp.join(save_path, "segm%d.npy" % (vi + 1)), segm_pred)
