"""Generic building blocks, channels-last (counterpart of ogc_tpu/nn/layers.py).

Reference utils/nn_util.py: a kernel-size-1 Conv1d/Conv2d is a per-point
linear map over the trailing channel axis; SharedMLP stacks conv + GroupNorm
+ ReLU.  Parameter names follow the reference state_dict
(``layer{j}.conv.weight``, ``layer{j}.normlayer.gn.weight``), and conv
weights keep the reference's (C_out, C_in, 1[, 1]) shape, so reference
checkpoints load unchanged.

Compute dtype (ogc_tpu/nn/layers.py:23-36): None is float32; bfloat16 is
the fast mode, set from the config by utils/config.py.  In bf16 a Conv1x1
runs its product in bf16 (parameters stay float32 and are cast), and
GroupNorm takes its statistics in float32 from per-channel sums and
normalises in bf16 (the JAX package's GroupStatsNorm, same parameters).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_COMPUTE_DTYPE: Optional[torch.dtype] = None  # None = float32


def set_compute_dtype(dtype: Optional[torch.dtype]) -> None:
    """Set the activation dtype of the pointwise stacks (None or
    torch.bfloat16)."""
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype


def compute_dtype() -> Optional[torch.dtype]:
    return _COMPUTE_DTYPE


def to_compute(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the compute dtype (float32 mode: as it is)."""
    return x if _COMPUTE_DTYPE is None else x.to(_COMPUTE_DTYPE)


def form_enabled(var: str) -> bool:
    """The JAX package's switches of the first layer's forms,
    ``OGC_EVAL_FOLD`` and ``OGC_TRAIN_SPLIT``: on unless set to ``off``
    (read at each call)."""
    return os.environ.get(var, "on") != "off"


class GroupNorm(nn.Module):
    """GroupNorm over the trailing channel axis of a (B, ..., C) tensor:
    statistics per sample and group over every position (flax nn.GroupNorm
    layout; the reference normalizes the same elements channels-first)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels in {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        if _COMPUTE_DTYPE is not None:
            return self._stats_norm(x)
        xg = x.reshape(B, -1, self.num_groups, C // self.num_groups)
        var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight + self.bias

    def _stats_norm(self, x: torch.Tensor) -> torch.Tensor:
        """GroupStatsNorm (ogc_tpu/nn/layers.py:80-137): group mean and
        E[x^2] - mean^2 in float32 from per-channel sums, applied in the
        activation's dtype."""
        B, C, G = x.shape[0], x.shape[-1], self.num_groups
        xf = x.float().reshape(B, -1, C)
        n = xf.shape[1] * (C // G)
        gmean = xf.sum(1).reshape(B, G, -1).sum(-1) / n
        gms = (xf * xf).sum(1).reshape(B, G, -1).sum(-1) / n
        k = torch.rsqrt(torch.clamp(gms - gmean ** 2, min=0.0) + self.eps)
        shape = (B,) + (1,) * (x.dim() - 2) + (C,)
        kc = k.repeat_interleave(C // G, -1).reshape(shape).to(x.dtype)
        mc = gmean.repeat_interleave(C // G, -1).reshape(shape).to(x.dtype)
        y = (x - mc) * kc
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class Conv1x1(nn.Module):
    """Kernel-size-1 convolution applied channels-last: (..., C_in) -> (..., C_out).

    :param conv_dims: 1 or 2 -- the weight keeps the reference Conv1d/Conv2d
        shape (C_out, C_in, 1[, 1]).
    """

    def __init__(self, in_channels: int, out_channels: int, bias: bool,
                 conv_dims: int = 2):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty((out_channels, in_channels) + (1,) * conv_dims))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        nn.init.kaiming_normal_(self.weight, mode="fan_in", nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.flatten(1), self.bias
        if _COMPUTE_DTYPE is not None:
            x, w = x.to(_COMPUTE_DTYPE), w.to(_COMPUTE_DTYPE)
            b = None if b is None else b.to(_COMPUTE_DTYPE)
        return F.linear(x, w, b)


class PointwiseConv(nn.Module):
    """Conv1x1 + optional GroupNorm + optional ReLU; bias only without a norm
    (reference utils/nn_util.py:45-107)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_groups: Optional[int] = None, act: bool = True,
                 conv_dims: int = 2):
        super().__init__()
        self.conv = Conv1x1(in_channels, out_channels, bias=num_groups is None,
                            conv_dims=conv_dims)
        self.normlayer = (
            nn.ModuleDict({"gn": GroupNorm(num_groups, out_channels)})
            if num_groups is not None else None)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.post(self.conv(x))

    def post(self, x: torch.Tensor) -> torch.Tensor:
        """The norm and activation after the product."""
        if self.normlayer is not None:
            x = self.normlayer["gn"](x)
        return F.relu(x) if self.act else x


class SharedMLP(nn.Module):
    """Stack of PointwiseConv + GroupNorm + ReLU (utils/nn_util.py:151-168).

    :param channels: output channels per layer (the reference's mlp[1:]).
    """

    def __init__(self, in_channels: int, channels: Sequence[int],
                 num_groups: Optional[int] = None):
        super().__init__()
        self.n_layers = len(channels)
        for j, c in enumerate(channels):
            self.add_module(f"layer{j}",
                            PointwiseConv(in_channels, c, num_groups))
            in_channels = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rest(self.layer0(x))

    def rest(self, x: torch.Tensor) -> torch.Tensor:
        """Every layer after the first."""
        for j in range(1, self.n_layers):
            x = getattr(self, f"layer{j}")(x)
        return x


def MLP(in_dim: int, hidden_dim: int, out_dim: int) -> nn.Sequential:
    """Linear -> ReLU -> Linear (utils/transformer_util.py:24-28, 79-83)."""
    return nn.Sequential(nn.Linear(in_dim, hidden_dim), nn.ReLU(),
                         nn.Linear(hidden_dim, out_dim))


def raw_split_inputs(xyz: torch.Tensor, new_xyz: torch.Tensor,
                     features: torch.Tensor, idx: torch.Tensor):
    """(raw, center_in) of the raw-gather split first layer
    (ogc_tpu/nn/layers.py::raw_split_inputs): one gather of the
    [xyz || features] rows and the per-centre correction input
    [center || zeros], so that a first product with no bias is
    ``W raw - W center_in``.  Shared by FlowSAModule and the GRU's
    convz / convr."""
    from ogc_tpu_torch import ops

    raw = ops.group(torch.cat([xyz, features], -1), idx)
    center_in = torch.cat(
        [new_xyz, new_xyz.new_zeros(new_xyz.shape[:2] + features.shape[-1:])],
        -1)
    return raw, center_in
