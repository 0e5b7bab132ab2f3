"""A/B on the card: the block-min KNN (#3, ops/knn_blockmin.py) against the
candidate-pruned KNN (#6, ops/knn_cand.py) at the model's hot shapes (the
port of tools/bench_knn_pruned.py, same cases, same JSON rows).

    python -m ogc_tpu_torch.tools.bench_knn_pruned [--reps 10] [--seed 0]

Clouds are ``scene_like_cloud`` (a ground plane and clusters, 30 m).  Each
time is the median of ``--reps`` calls, CUDA events around each, after one
warm-up call; #6's time includes its prologue (Morton sorts, bounds,
candidate choice), as a caller pays it.  Prints one JSON row per shape, then
a summary line naming the device.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from ogc_tpu_torch.ops.knn_blockmin import knn_blockmin
from ogc_tpu_torch.ops.knn_cand import knn_cand
from ogc_tpu_torch.tools.synth import scene_like_cloud

# (B, N queries, M points, k, [(n_cand_blocks, blk)]): the encoder's SA1
# search and the FlowEmbedding / lr_idx search (tools/bench_knn_pruned.py).
CASES = [(8, 4096, 8192, 32, [(32, 4), (28, 4)]),
         (8, 2048, 2048, 16, [(12, 4), (10, 2)])]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_knn_pruned: needs a CUDA device")
    rng = np.random.RandomState(args.seed)

    def clouds(b, n):
        return torch.from_numpy(np.stack([scene_like_cloud(rng, n)
                                          for _ in range(b)])).cuda()

    results = []
    for B, N, M, k, cfgs in CASES:
        q, p = clouds(B, N), clouds(B, M)
        t_flash = cuda_ms(lambda: knn_blockmin(q, p, k, 0.95), args.reps)
        row = {"shape": f"B{B} N{N} M{M} k{k}", "flash_ms": t_flash}
        for bc, blk in cfgs:
            t = cuda_ms(lambda: knn_cand(q, p, k, bc, blk=blk), args.reps)
            row[f"pruned_bc{bc}_blk{blk}_ms"] = t
            row[f"speedup_bc{bc}_blk{blk}"] = t_flash / t
        results.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"bench": "knn_pruned_ab",
                      "device": torch.cuda.get_device_name(0),
                      "results": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
