"""KITTI Detection single-frame dataset (cross-dataset segnet evaluation).

Parity with reference datasets/dataset_kittidet.py: per-scene
downsampled/<id>/{pc,segm}.npy, optional reload of saved segmentation
predictions (with per-object confidences), frames duplicated into the
uniform two-frame item format with zero flows.  Copy of
ogc_tpu/data/kittidet.py.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import List, Optional

import numpy as np

from ogc_tpu_torch.data.augment import (
    augment_transform,
    batch_segm_to_mask,
    batch_segm_to_mask_withconf,
    compress_label_id,
)


class KITTIDetectionDataset:
    def __init__(
        self,
        data_root: str,
        mapping_path: str,
        decentralize: bool = False,
        aug_transform: bool = False,
        aug_transform_args: Optional[dict] = None,
        onehot_label: bool = False,
        max_n_object: int = 18,
        ignore_npoint_thresh: int = 0,
        load_prediction: Optional[str] = None,
        load_confidence: bool = False,
    ):
        self.data_root = osp.join(data_root, "downsampled")
        with open(mapping_path) as f:
            self.data_ids = f.read().strip().split("\n")

        self.decentralize = decentralize
        self.aug_transform = aug_transform
        self.aug_transform_args = aug_transform_args
        self.onehot_label = onehot_label
        self.max_n_object = max_n_object
        self.ignore_npoint_thresh = ignore_npoint_thresh

        if load_prediction is not None:
            self.predsegm_path = osp.join(data_root, "segm_preds", load_prediction)
            print("Load segmentation predictions from", self.predsegm_path)
        else:
            self.predsegm_path = None
        self.load_confidence = load_confidence

    def __len__(self):
        return len(self.data_ids)

    def _load_data(self, idx):
        data_path = osp.join(self.data_root, self.data_ids[idx])
        pc = np.load(osp.join(data_path, "pc.npy"))
        segm = np.load(osp.join(data_path, "segm.npy"))
        return pc, segm

    def _load_predsegm(self, idx):
        data_path = osp.join(self.predsegm_path, self.data_ids[idx])
        segm = np.load(osp.join(data_path, "segm.npy"))
        if self.load_confidence:
            conf = np.load(osp.join(data_path, "conf.npy")).astype(np.float32)
        else:
            conf = np.ones((self.max_n_object,), dtype=np.float32)
        return segm, conf

    def __getitem__(self, sid):
        pc, segm = self._load_data(sid)
        conf = None
        if self.predsegm_path is not None:
            segm, conf = self._load_predsegm(sid)

        if self.decentralize:
            pc = pc - pc.mean(0)

        segm = compress_label_id(segm)
        pcs = np.stack([pc, pc], 0)
        segms = np.stack([segm, segm], 0)
        flows = np.zeros_like(pcs)

        if self.onehot_label:
            assert self.max_n_object > 0
            if self.predsegm_path is not None:
                segms, valids = batch_segm_to_mask_withconf(
                    segms, [conf, conf], self.max_n_object,
                    self.ignore_npoint_thresh,
                )
            else:
                segms, valids = batch_segm_to_mask(
                    segms, self.max_n_object, self.ignore_npoint_thresh
                )
        else:
            valids = np.ones_like(segms, dtype=np.float32)

        if self.aug_transform:
            pcs, flows = augment_transform(pcs, flows, self.aug_transform_args)
            segms = np.concatenate((segms, segms), 0)
            valids = np.concatenate((valids, valids), 0)

        segm_dtype = np.float32 if self.onehot_label else np.int32
        return (
            pcs.astype(np.float32),
            segms.astype(segm_dtype),
            flows.astype(np.float32),
            valids.astype(np.float32),
        )

    def _save_predsegm(self, mask, save_root, batch_size, n_frame=1, offset=0):
        mask = np.asarray(mask)
        for sid in range(mask.shape[0]):
            segm_pred = mask[sid].argmax(1)
            data_id = self.data_ids[offset * batch_size + sid]
            save_path = osp.join(save_root, data_id)
            os.makedirs(save_path, exist_ok=True)
            np.save(os.path.join(save_path, "segm.npy"), segm_pred)
