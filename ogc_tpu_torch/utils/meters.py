"""Loss meters (reference utils/pytorch_util.py:9-69); copy of
ogc_tpu/utils/meters.py."""

from __future__ import annotations

from typing import Dict


class AverageMeter:
    def __init__(self):
        self.loss_dict: Dict[str, list] = {}

    def append_loss(self, losses: Dict[str, float]) -> None:
        for k, v in losses.items():
            v = float(v)
            self.loss_dict.setdefault(k, []).append(v)

    def get_mean_loss_dict(self) -> Dict[str, float]:
        return {k: sum(v) / max(len(v), 1) for k, v in self.loss_dict.items()}

    def get_mean_loss(self) -> float:
        d = self.get_mean_loss_dict()
        return sum(d.values()) / max(len(d), 1)


class RunningAverageMeter:
    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.loss_dict: Dict[str, float] = {}

    def append_loss(self, losses: Dict[str, float]) -> None:
        for k, v in losses.items():
            v = float(v)
            if k not in self.loss_dict:
                self.loss_dict[k] = v
            else:
                old = self.loss_dict[k]
                self.loss_dict[k] = self.alpha * v + (1 - self.alpha) * old

    def get_loss_dict(self) -> Dict[str, float]:
        return dict(self.loss_dict)
