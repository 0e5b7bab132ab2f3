"""Dataset base class + a threaded, prefetching batch loader (copy of
ogc_tpu/data/base.py: the port imports nothing of ``ogc_tpu``).

The reference uses torch DataLoader workers (train_seg.py:324); here the host
pipeline is a plain thread pool feeding stacked numpy batches.  All datasets
return the uniform item (pcs (T,N,3), segms, flows (T,N,3), valids) of the
reference (SURVEY §2b).  Under data parallelism the loader yields this
rank's row block of each global batch (``DataLoader``).
"""

from __future__ import annotations

import concurrent.futures as _futures
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ogc_tpu_torch.data.augment import (
    augment_transform,
    batch_segm_to_mask,
    compress_label_id,
)
from ogc_tpu_torch.parallel import mesh


class PairFrameDataset:
    """Shared post-processing for the two-frame (+augmented) datasets.

    Subclasses implement `_load_item(idx, view_sel) -> (pcs, segms, flows)`
    with pcs/segms/flows stacked over the 2 frames, plus the predflow loader
    and the save-back hooks.
    """

    data_ids: List
    view_sels: List[List[int]]
    decentralize: bool = False
    aug_transform: bool = False
    aug_transform_args: Optional[dict] = None
    onehot_label: bool = False
    max_n_object: int = 8
    ignore_npoint_thresh: int = 0

    def __len__(self) -> int:
        return len(self.data_ids) * len(self.view_sels)

    def _load_item(self, idx: int, view_sel: List[int]):
        raise NotImplementedError

    def __getitem__(self, sid: int):
        idx, vi = sid // len(self.view_sels), sid % len(self.view_sels)
        view_sel = self.view_sels[vi]
        pcs, segms, flows = self._load_item(idx, view_sel)

        if self.decentralize:
            center = pcs.mean(1).mean(0)
            pcs = pcs - center

        segms = compress_label_id(segms.reshape(-1)).reshape(2, -1)

        if self.onehot_label:
            assert self.max_n_object > 0
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


class Batch(tuple):
    """A loader's batch: the stacked fields, with ``true_b``, how many of
    its rows are true (the rest repeat the global batch's last row), and
    ``global_b``, the global batch's true rows."""

    true_b: int
    global_b: int


class DataLoader:
    """Minimal batching loader: shuffle, stack, background prefetch.

    Drops no remainder by default (the reference keeps partial batches, and
    so do we — eval code must handle a smaller final batch).

    Under a world of W ranks (``rank``/``world_size``, by default the
    process group's) every rank draws the same seeded permutation and loads
    only its row block of each global batch of ``batch_size``, padded to a
    multiple of W by repeating the last index (``mesh.shard_padded``'s
    blocks); a repeated index is loaded once.  The union over ranks is the
    single-process batch.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        drop_last: bool = False,
        prefetch: int = 2,
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
    ):
        if rank is None:
            rank, world_size = mesh.world()
        self.rank, self.world_size = rank, world_size
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self) -> List[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        return [
            order[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(nb)
        ]

    def _local(self, idx: np.ndarray) -> Tuple[np.ndarray, int]:
        """This rank's padded indices of a global batch and how many of
        them are true."""
        b, r, w = len(idx), self.rank, self.world_size
        if w == 1:
            return idx, b
        (block,), _ = mesh.shard_padded([idx], r, w)
        return block, mesh.true_rows(b, r, w)

    def __iter__(self) -> Iterator[Batch]:
        batches = self._batch_indices()
        pool = _futures.ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def fetch(global_idx):
            idx, true_b = self._local(global_idx)
            # Each distinct index loaded once, so a padded row is a copy.
            _, first = np.unique(idx, return_index=True)
            uniq = idx[np.sort(first)]
            items = dict(zip(uniq.tolist(),
                             pool.map(self.dataset.__getitem__, uniq)))
            out = Batch(np.stack(f, 0)
                        for f in zip(*(items[i] for i in idx.tolist())))
            out.true_b, out.global_b = true_b, len(global_idx)
            return out

        def producer():
            # Worker exceptions are forwarded to the consumer and re-raised
            # there: a dataset error (e.g. a missing predflow file) must
            # fail the epoch loudly, not silently yield an empty epoch.
            try:
                for bi in batches:
                    if stop.is_set():
                        break
                    q.put(fetch(bi))
            except BaseException as e:  # noqa: BLE001
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit.
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            pool.shutdown(wait=False)
