"""Scene-flow metrics: EPE3D, Acc3DS, Acc3DR, Outliers3D (copy of
ogc_tpu/metrics/flow.py).

Parity port of the reference metrics/flow_metric.py:4-25 (dataset-scaled
threshold: 0.01 indoor / 0.05 outdoor).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def eval_flow(
    gt_flow: np.ndarray,
    flow_pred: np.ndarray,
    epe_norm_thresh: float = 0.05,
    eps: float = 1e-10,
) -> Tuple[float, float, float, float]:
    """
    :param gt_flow: (B, N, 3); :param flow_pred: (B, N, 3).
    :return: (epe, acc_strict, acc_relax, outlier).
    """
    gt_flow = np.asarray(gt_flow)
    flow_pred = np.asarray(flow_pred)
    epe_norm = np.linalg.norm(flow_pred - gt_flow, axis=2)
    sf_norm = np.linalg.norm(gt_flow, axis=2)
    rel = epe_norm / (sf_norm + eps)
    epe = float(epe_norm.mean())
    acc_s = float(
        np.logical_or(epe_norm < epe_norm_thresh, rel < 0.05).mean()
    )
    acc_r = float(
        np.logical_or(epe_norm < 2 * epe_norm_thresh, rel < 0.1).mean()
    )
    outlier = float(
        np.logical_or(epe_norm > 6 * epe_norm_thresh, rel > 0.1).mean()
    )
    return epe, acc_s, acc_r, outlier
