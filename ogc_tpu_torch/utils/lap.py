"""Linear assignment on the host (numpy), step for step the solver of
ogc_tpu/utils/lap.py.

The invariance loss matches object masks by IoU, and on random-weight masks
the IoU matrix is degenerate: many assignments tie at the optimum and the
loss depends on which one is picked.  So this is not "any optimal solver":
it repeats the JAX package's shortest-augmenting-path (Jonker-Volgenant)
steps in float32 with the same first-index argmin, and returns the same
``col_ind`` on tied matrices too.
"""

from __future__ import annotations

import numpy as np

_INF = np.float32(1e30)


def _solve_one(cost: np.ndarray) -> np.ndarray:
    """Square LAP, minimising: (K, K) -> col4row (K,) int32."""
    K = cost.shape[0]
    cost = cost.astype(np.float32)
    u = np.zeros(K, np.float32)
    v = np.zeros(K, np.float32)
    col4row = np.full(K, -1, np.int32)
    row4col = np.full(K, -1, np.int32)
    zero = np.float32(0.0)
    for cur_row in range(K):
        # Dijkstra over reduced costs from cur_row until an unassigned
        # column (the sink) is reached.
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
        # Dual updates (scipy rectangular_lsap.cpp).
        u[cur_row] = u[cur_row] + min_val
        visited_other = sr & (np.arange(K) != cur_row)
        u = u + np.where(visited_other,
                         min_val - shortest[np.clip(col4row, 0, K - 1)], zero)
        v = v - np.where(done, min_val - shortest, zero)
        # Augment along the alternating path back to cur_row.
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


def linear_sum_assignment(cost: np.ndarray, maximize: bool = False
                          ) -> np.ndarray:
    """Batched square linear assignment.

    :param cost: (..., K, K).  :return: (..., K) int32 ``col_ind``, the
        column assigned to each row.
    """
    cost = np.asarray(cost, np.float32)
    if maximize:
        cost = -cost
    K = cost.shape[-1]
    flat = cost.reshape(-1, K, K)
    out = np.stack([_solve_one(c) for c in flat]) if len(flat) else \
        np.zeros((0, K), np.int32)
    return out.reshape(cost.shape[:-2] + (K,))
