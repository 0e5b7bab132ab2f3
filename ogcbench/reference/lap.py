"""Square linear assignment in numpy: a frozen copy of the port's solver
(shortest augmenting paths, Jonker-Volgenant, in float32 with the first
index winning every argmin).  On random-weight masks the IoU matrix is
degenerate and many assignments tie at the optimum; the invariance loss
depends on which one is picked, so the reference picks as the port does.
"""

from __future__ import annotations

import numpy as np

_INF = np.float32(1e30)


def _solve_one(cost: np.ndarray) -> np.ndarray:
    K = cost.shape[0]
    cost = cost.astype(np.float32)
    u = np.zeros(K, np.float32)
    v = np.zeros(K, np.float32)
    col4row = np.full(K, -1, np.int32)
    row4col = np.full(K, -1, np.int32)
    zero = np.float32(0.0)
    for cur_row in range(K):
        shortest = np.full(K, _INF, np.float32)
        pred = np.zeros(K, np.int32)
        done = np.zeros(K, bool)
        sr = np.zeros(K, bool)
        min_val = zero
        sink = -1
        i = cur_row
        while sink < 0:
            sr[i] = True
            d = min_val + cost[i] - u[i] - v
            upd = ~done & (d < shortest)
            pred = np.where(upd, np.int32(i), pred)
            shortest = np.where(upd, d, shortest)
            masked = np.where(done, _INF, shortest)
            j = int(np.argmin(masked))
            min_val = masked[j]
            done[j] = True
            if row4col[j] < 0:
                sink = j
            else:
                i = int(row4col[j])
        u[cur_row] = u[cur_row] + min_val
        visited_other = sr & (np.arange(K) != cur_row)
        u = u + np.where(visited_other,
                         min_val - shortest[np.clip(col4row, 0, K - 1)], zero)
        v = v - np.where(done, min_val - shortest, zero)
        j = sink
        while True:
            i = int(pred[j])
            row4col[j] = i
            nxt = int(col4row[i])
            col4row[i] = j
            j = nxt
            if i == cur_row:
                break
    return col4row


def assign_max(score: np.ndarray) -> np.ndarray:
    """(B, K, K) scores -> (B, K) int64: the column assigned to each row
    under the largest total score."""
    cost = -np.asarray(score, np.float32)
    return np.stack([_solve_one(c) for c in cost]).astype(np.int64)
