"""Waymo Open datasets: two-frame (backward-flow-only) and single-frame.

Parity with reference datasets/dataset_waymo.py and
dataset_waymo_singleframe.py: sequences of pc_%04d / segm_%04d /
semantic_segm_%04d npy files, flow_%04d_%04d backward flows (Waymo provides
only backward flow: view pairs are (t, t-1), dataset_waymo.py:71-74),
semantic-class and object-size filtering into per-point valid masks
(:110-128).  Copy of ogc_tpu/data/waymo.py (``np.isin`` for the
deprecated ``np.in1d``: the same masks).
"""

from __future__ import annotations

import glob
import json
import os
import os.path as osp
from typing import List, Optional

import numpy as np

from ogc_tpu_torch.data.augment import augment_transform, compress_label_id

CLASS_NAMES = {"Vehicle": 1, "Pedestrian": 2, "Cyclist": 3}


def _filter_segm(segms, semantic_segms, ignore_class_ids, ignore_npoint_thresh):
    """Zero out ignored classes / too-small objects; return valid masks
    (dataset_waymo.py:110-128)."""
    segms_f, valids = [], []
    for segm, sem in zip(segms, semantic_segms):
        segm = segm.copy()
        ignore_by_class = np.isin(sem, ignore_class_ids)
        ids, sizes = np.unique(segm, return_counts=True)
        small = ids[sizes < ignore_npoint_thresh]
        ignore_by_size = np.isin(segm, small)
        ignore = np.logical_or(ignore_by_class, ignore_by_size)
        segm[ignore] = 0
        segms_f.append(segm)
        valids.append(1 - ignore.astype(np.int32))
    return segms_f, valids


class WaymoOpenDataset:
    """Two-frame Waymo dataset (reference datasets/dataset_waymo.py)."""

    def __init__(
        self,
        data_root: str,
        mapping_path: str,
        downsampled: bool = False,
        select_frame: Optional[str] = None,
        sampled_interval: int = 1,
        predflow_path: Optional[str] = None,
        decentralize: bool = False,
        aug_transform: bool = False,
        aug_transform_args: Optional[dict] = None,
        ignore_class_ids: List[int] = [],
        ignore_npoint_thresh: int = 0,
    ):
        self.data_root = osp.join(data_root, "data")
        self.sequence_list = [x.strip() for x in open(mapping_path).readlines()]
        self.downsampled = downsampled

        if select_frame is not None:
            with open(select_frame) as f:
                self.data_ids = [tuple(d) for d in json.load(f)]
            print("Loaded %d Waymo samples from %s" % (len(self.data_ids), select_frame))
        else:
            self.data_ids = self._make_dataset(sampled_interval)

        if predflow_path is not None:
            self.predflow_path = osp.join(data_root, "flow_preds", predflow_path)
        else:
            self.predflow_path = None

        self.decentralize = decentralize
        self.aug_transform = aug_transform
        self.aug_transform_args = aug_transform_args
        self.ignore_class_ids = ignore_class_ids
        self.ignore_npoint_thresh = ignore_npoint_thresh

    def _make_dataset(self, sampled_interval):
        data_ids, num_skipped = [], 0
        for seq in self.sequence_list:
            sequence_name = osp.splitext(seq)[0]
            sequence_path = osp.join(self.data_root, sequence_name)
            if not osp.exists(sequence_path):
                num_skipped += 1
                continue
            n_frame = len(glob.glob(osp.join(sequence_path, "pc_*")))
            # Waymo only contains backward scene flow.
            for t in range(1, n_frame):
                data_ids.append((sequence_name, t, t - 1))
        if sampled_interval > 1:
            data_ids = data_ids[::sampled_interval]
        print(
            "Waymo dataset: %d samples; %d/%d sequences unavailable."
            % (len(data_ids), num_skipped, len(self.sequence_list))
        )
        return data_ids

    def __len__(self):
        return len(self.data_ids)

    def _load_data(self, sequence_name, v1, v2):
        p = osp.join(self.data_root, sequence_name)
        pcs = [np.load(osp.join(p, "pc_%04d.npy" % v)) for v in (v1, v2)]
        segms = [np.load(osp.join(p, "segm_%04d.npy" % v)) for v in (v1, v2)]
        sems = [
            np.load(osp.join(p, "semantic_segm_%04d.npy" % v)) for v in (v1, v2)
        ]
        return pcs, segms, sems

    def _load_flow(self, root, sequence_name, v1, v2):
        flow = np.load(
            osp.join(root, sequence_name, "flow_%04d_%04d.npy" % (v1, v2))
        )
        return [flow, flow]

    def __getitem__(self, sid):
        sequence_name, v1, v2 = self.data_ids[sid]
        pcs, segms, sems = self._load_data(sequence_name, v1, v2)
        if self.predflow_path is not None:
            flows = self._load_flow(self.predflow_path, sequence_name, v1, v2)
        else:
            flows = self._load_flow(self.data_root, sequence_name, v1, v2)

        segms, valids = _filter_segm(
            segms, sems, self.ignore_class_ids, self.ignore_npoint_thresh
        )

        if not self.downsampled:
            return pcs, segms, flows, valids

        pcs = np.stack(pcs, 0)
        segms = np.stack(segms, 0)
        flows = np.stack(flows, 0)
        valids = np.stack(valids, 0)

        if self.decentralize:
            pcs = pcs - pcs.mean(1).mean(0)

        segms = compress_label_id(segms.reshape(-1)).reshape(2, -1)

        if self.aug_transform:
            pcs, flows = augment_transform(pcs, flows, self.aug_transform_args)
            segms = np.concatenate((segms, segms), 0)
            valids = np.concatenate((valids, valids), 0)

        return (
            pcs.astype(np.float32),
            segms.astype(np.int32),
            flows.astype(np.float32),
            valids.astype(np.float32),
        )

    def _save_predflow(self, flow_pred, save_root, batch_size, n_frame=1, offset=0):
        flow_pred = np.asarray(flow_pred)
        for sid in range(flow_pred.shape[0]):
            idx = (offset * batch_size + sid) // n_frame
            sequence_name, v1, v2 = self.data_ids[idx]
            save_path = osp.join(save_root, sequence_name)
            os.makedirs(save_path, exist_ok=True)
            np.save(
                osp.join(save_path, "flow_%04d_%04d.npy" % (v1, v2)),
                flow_pred[sid],
            )


class WaymoOpenSingleFrameDataset:
    """Single-frame Waymo dataset (reference dataset_waymo_singleframe.py).

    Items: (pcs (T,N,3), segms, valids) — note: NO flow entry, matching the
    reference's 3-tuple."""

    def __init__(
        self,
        data_root: str,
        mapping_path: str,
        downsampled: bool = False,
        select_frame: Optional[str] = None,
        sampled_interval: int = 1,
        decentralize: bool = False,
        aug_transform: bool = False,
        aug_transform_args: Optional[dict] = None,
        onehot_label: bool = False,
        max_n_object: int = 20,
        ignore_class_ids: List[int] = [],
        ignore_npoint_thresh: int = 0,
    ):
        self.data_root = osp.join(data_root, "data")
        self.sequence_list = [x.strip() for x in open(mapping_path).readlines()]
        self.downsampled = downsampled

        if select_frame is not None:
            with open(select_frame) as f:
                self.data_ids = [tuple(d) for d in json.load(f)]
        else:
            self.data_ids = self._make_dataset(sampled_interval)

        self.decentralize = decentralize
        self.aug_transform = aug_transform
        self.aug_transform_args = aug_transform_args
        self.onehot_label = onehot_label
        self.max_n_object = max_n_object
        self.ignore_class_ids = ignore_class_ids
        self.ignore_npoint_thresh = ignore_npoint_thresh

    def _make_dataset(self, sampled_interval):
        data_ids, num_skipped = [], 0
        for seq in self.sequence_list:
            sequence_name = osp.splitext(seq)[0]
            sequence_path = osp.join(self.data_root, sequence_name)
            if not osp.exists(sequence_path):
                num_skipped += 1
                continue
            n_frame = len(glob.glob(osp.join(sequence_path, "pc_*")))
            for t in range(n_frame):
                data_ids.append((sequence_name, t))
        if sampled_interval > 1:
            data_ids = data_ids[::sampled_interval]
        return data_ids

    def __len__(self):
        return len(self.data_ids)

    def _load_data(self, sequence_name, view_id):
        p = osp.join(self.data_root, sequence_name)
        pc = np.load(osp.join(p, "pc_%04d.npy" % view_id))
        segm = np.load(osp.join(p, "segm_%04d.npy" % view_id))
        sem = np.load(osp.join(p, "semantic_segm_%04d.npy" % view_id))
        return [pc], [segm], [sem]

    def __getitem__(self, sid):
        sequence_name, view_id = self.data_ids[sid]
        pcs, segms, sems = self._load_data(sequence_name, view_id)
        segms, valids = _filter_segm(
            segms, sems, self.ignore_class_ids, self.ignore_npoint_thresh
        )

        if not self.downsampled:
            return pcs, segms, valids

        pcs = np.stack(pcs, 0)
        segms = np.stack(segms, 0)
        valids = np.stack(valids, 0)

        if self.decentralize:
            pcs = pcs - pcs.mean(1).mean(0)

        segms = compress_label_id(segms.reshape(-1)).reshape(segms.shape)

        if self.onehot_label:
            assert self.max_n_object > 0
            oh = np.eye(self.max_n_object, dtype=np.float32)[segms]
            segms = oh * valids[..., None]

        if self.aug_transform:
            pcs2 = np.concatenate((pcs, pcs), 0)
            flows = np.zeros_like(pcs2)
            pcs2, _ = augment_transform(pcs2, flows, self.aug_transform_args)
            pcs = pcs2[[0, 2]]
            segms = np.concatenate((segms, segms), 0)
            valids = np.concatenate((valids, valids), 0)

        if self.onehot_label:
            return (
                pcs.astype(np.float32),
                segms.astype(np.float32),
                valids.astype(np.float32),
            )
        return (
            pcs.astype(np.float32),
            segms.astype(np.int32),
            valids.astype(np.int32),
        )

    def _save_predsegm(self, mask, save_root, batch_size, n_frame=1, offset=0):
        mask = np.asarray(mask)
        for sid in range(mask.shape[0]):
            segm_pred = mask[sid].argmax(1)
            sequence_name, view_id = self.data_ids[offset * batch_size + sid]
            save_path = osp.join(save_root, sequence_name)
            os.makedirs(save_path, exist_ok=True)
            np.save(osp.join(save_path, "segm_%04d.npy" % view_id), segm_pred)
