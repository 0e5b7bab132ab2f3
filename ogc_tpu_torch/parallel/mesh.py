"""Data parallelism over the batch axis (counterpart of
ogc_tpu/parallel/mesh.py) with ``torch.distributed``.

Training runs one process a card, launched by ``torchrun`` (``python -m
torch.distributed.run``), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; with none of them set
``init_data_parallel`` starts nothing and the trainers run single-process.
The semantics are the JAX package's: rank r takes the contiguous row block
``[r * b / W, (r + 1) * b / W)`` of the global batch, padded to a multiple
of the world size W by repeating its last row (``shard_padded``); each rank
computes the loss on its own rows, and gradients and scalars are averaged
over ranks (``all_reduce_mean``, the counterpart of ``jax.lax.pmean``).
Parameters stay identical on every rank: every rank starts from rank 0's
state (``broadcast_from_main``, as the trainers do before their first
epoch) and applies the same averaged update; no
DistributedDataParallel wrapper is used (its hooks see only ``forward``,
and its buffer broadcast is not the JAX package's average of the BatchNorm
statistics).

Evaluation shards one process's batch over local devices instead
(``eval_devices``, ``dp_eval_fwd``): the CLIs' ``--dp N``.
"""

from __future__ import annotations

import contextlib
import copy
import os
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ogc_tpu_torch.utils import trace

#: the launcher's variables, all set or none
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_data_parallel(device, share_device: bool = False) -> torch.device:
    """Join the process group the launcher's environment describes and
    return this rank's device, made the current card; with none of ``ENV``
    set, start nothing and return ``device`` (current, if a card index).

    CUDA takes NCCL, each rank on ``cuda:LOCAL_RANK``; the CPU takes gloo.
    ``share_device=True`` keeps every rank on ``device`` itself (NCCL
    refuses two ranks on one card) and takes gloo, which stages the CUDA
    tensors through the host: a correctness arm on one card, not a way to
    scale."""
    device = torch.device(device)
    present = [k for k in ENV if k in os.environ]
    if not present:
        if device.type == "cuda" and device.index is not None:
            # The kernels launch with the current card: make it this one.
            torch.cuda.set_device(device)
        return device
    if len(present) != len(ENV):
        raise RuntimeError(f"data parallelism needs all of {ENV}; only "
                           f"{present} are set")
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda" and not share_device:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        backend = "nccl"
    else:
        backend = "gloo"
    if device.type == "cuda":
        device = _indexed(device)
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method="tcp://%s:%s" % (os.environ["MASTER_ADDR"],
                                             os.environ["MASTER_PORT"]),
        rank=rank, world_size=size)
    return device


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main() -> bool:
    return world()[0] == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def pad_batch(arrays: Sequence[np.ndarray], target_b: int) -> tuple:
    """Pad axis 0 of each array to ``target_b`` by repeating its last row
    (ogc_tpu/parallel/mesh.py:243)."""
    def pad(x):
        if x.shape[0] == target_b:
            return x
        return np.concatenate(
            [x, np.repeat(x[-1:], target_b - x.shape[0], axis=0)], 0)

    return tuple(pad(x) for x in arrays)


def padded_size(b: int, size: int) -> int:
    """``b`` rounded up to a multiple of ``size``."""
    return -(-b // size) * size


def row_block(b: int, rank: int, size: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``b`` padded to a multiple
    of ``size``."""
    s = padded_size(b, size) // size
    return slice(rank * s, (rank + 1) * s)


def shard_padded(arrays: Sequence[np.ndarray], rank: Optional[int] = None,
                 size: Optional[int] = None) -> Tuple[tuple, int]:
    """This rank's padded row block of each array of a global batch, and
    the batch's true size (mesh.py:81-110, one process a rank)."""
    if rank is None:
        rank, size = world()
    b = arrays[0].shape[0]
    block = row_block(b, rank, size)
    return tuple(a[block] for a in pad_batch(arrays,
                                             padded_size(b, size))), b


def true_rows(b: int, rank: int, size: int) -> int:
    """How many of rank ``rank``'s padded rows of a global batch of ``b``
    are true rows (the rest repeat row ``b - 1``)."""
    block = row_block(b, rank, size)
    return max(0, min(block.stop, b) - block.start)


def global_batch_size(b_local: int) -> int:
    """The sum over ranks of their true row counts (mesh.py:113)."""
    if not dist.is_initialized():
        return int(b_local)
    t = torch.tensor([int(b_local)], dtype=torch.int64,
                     device=_collective_device())
    dist.all_reduce(t)
    return int(t.item())


def _collective_device() -> torch.device:
    """Where the backend's tensors live: the current card for NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_mean(tensors: List[torch.Tensor]) -> None:
    """Average each tensor over ranks, in place, with one collective per
    dtype: the tensors are flattened into one buffer (as the JAX package's
    one fused all-reduce of a pytree, ogc_tpu/train/flow.py:114-119).  A
    no-op without a process group."""
    if not dist.is_initialized() or not tensors:
        return
    size = dist.get_world_size()
    for group in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(size)
        _unflatten(flat, group)


@torch.no_grad()
def broadcast_from_main(tensors: List[torch.Tensor]) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place, with one
    collective per dtype (flattened as in ``all_reduce_mean``).  A no-op
    without a process group."""
    if not dist.is_initialized() or not tensors:
        return
    for group in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=0)
        _unflatten(flat, group)


def _by_dtype(tensors: List[torch.Tensor]) -> list:
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return list(groups.values())


def _unflatten(flat: torch.Tensor, group: List[torch.Tensor]) -> None:
    off = 0
    for t in group:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


class _MeanOverRanks(torch.autograd.Function):
    """The average over ranks with a backward: the cotangent is averaged
    too, as the transpose of ``jax.lax.pmean`` in a shard_map region."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y / dist.get_world_size()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g / dist.get_world_size()


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over ranks, differentiable (global BatchNorm)."""
    return _MeanOverRanks.apply(x)


def all_gather_objects(obj: Any) -> list:
    """Every rank's ``obj`` in rank order; ``[obj]`` without a process
    group."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def local_values(t: torch.Tensor, true_b: Optional[int] = None
                 ) -> np.ndarray:
    """This rank's rows of ``t`` on the host, cut to its ``true_b`` true
    rows (mesh.py:221)."""
    return (t if true_b is None else t[:true_b]).detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Evaluation: one process, the batch sharded over local devices.
# ---------------------------------------------------------------------------


def _indexed(device) -> torch.device:
    """``device`` with its card index (``cuda`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def eval_devices(n_devices: int, device) -> List[torch.device]:
    """The devices of ``--dp n_devices``: 0 means every local card (one
    CPU on the CPU), 1 the device itself.  On the CPU, N means N replicas
    there (how the CPU tests shard).  More cards than the machine has
    raises (mesh.py:176-181)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * max(n_devices, 1)
    if n_devices == 1:
        return [_indexed(device)]
    count = torch.cuda.device_count()
    n = count if n_devices == 0 else n_devices
    if n > count:
        raise ValueError(
            f"n_devices={n_devices} exceeds the {count} local "
            "devices (multi-host serving shards each process's loader "
            "separately; pass 0 for all local devices)")
    return [torch.device("cuda", i) for i in range(n)]


def _on(device: torch.device):
    """``device`` made the current card for the block (nothing on the
    CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def dp_eval_fwd(fn: Callable, devices: Sequence[torch.device],
                module: Optional[torch.nn.Module] = None) -> Callable:
    """Wrap a per-batch eval forward for data-parallel serving
    (mesh.py:150-218).

    :param fn: ``fn(module, *tensors)`` -> a tree (dict / list / tuple) of
        tensors with a leading batch axis, the module being the replica on
        the shard's device (None without ``module``).
    :param devices: one entry a shard; a device may repeat (the shards then
        run one after another on it).  One replica of ``module`` is kept
        per distinct device, the module itself where it already lies.
    :return: ``f(*arrays)`` (numpy arrays or tensors) -> the same tree as
        numpy arrays, sliced back to the true batch.

    The batch is padded to a multiple of ``len(devices)`` by repeating its
    last row, split into contiguous blocks, every block launched before
    any output is read (the cards then run together), and the outputs are
    gathered in order.  Eval forwards are per sample, so sharding is exact
    up to the kernels' own per-batch choices.  Under a profiler a call
    records the spans ``flow.batch`` > ``flow.h2d``, ``sync.flow_out``
    (utils/trace.py), named after ``test_flow``'s use of it."""
    devices = [_indexed(d) for d in devices]
    replicas = {}
    if module is not None:
        home = next(iter(module.parameters())).device
        for d in devices:
            if d not in replicas:
                replicas[d] = module if d == home else \
                    copy.deepcopy(module).to(d)

    def write(a: np.ndarray, d: torch.device) -> torch.Tensor:
        a = torch.from_numpy(a)
        # a copy from pageable memory waits for the stream
        with trace.span("sync.flow_in"):
            return a.to(d)

    def read(t: torch.Tensor) -> np.ndarray:
        with trace.span("sync.flow_out"):
            return t.cpu().numpy()

    @torch.no_grad()
    def fwd(*arrays):
        with trace.span("flow.batch", step=True):
            arrays = [a.detach().cpu().numpy() if torch.is_tensor(a)
                      else np.asarray(a) for a in arrays]
            b, n = arrays[0].shape[0], len(devices)
            padded = pad_batch(arrays, padded_size(b, n))
            outs = []
            for r, d in enumerate(devices):
                block = row_block(b, r, n)
                # The kernels launch on the current card's context: make it
                # the shard's.
                with _on(d):
                    with trace.span("flow.h2d"):
                        xs = [write(np.ascontiguousarray(a[block]), d)
                              for a in padded]
                    outs.append(fn(replicas.get(d), *xs))
            host = [_tree_map(read, o) for o in outs]
            leaves = [_leaves(h) for h in host]
            cat = iter([np.concatenate(parts, 0)[:b]
                        for parts in zip(*leaves)])
            return _tree_map(lambda _: next(cat), host[0])

    return fwd
