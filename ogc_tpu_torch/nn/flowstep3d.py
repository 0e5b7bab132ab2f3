"""FlowStep3D building blocks in eval mode, channels-last (counterpart of
ogc_tpu/nn/flowstep3d.py).

KNN-grouped set abstraction with BatchNorm, cross-cloud FlowEmbedding
correlation and MLP-free feature propagation (reference
utils/flowstep3d_util.py).  Parameter names and shapes follow the reference
state_dict: ``mlp_convs.{j}.weight`` (C_out, C_in, 1, 1) and
``mlp_bns.{j}.{weight,bias,running_mean,running_var,num_batches_tracked}``,
so reference checkpoints load unchanged.

Eval forwards only, in float32, as the JAX package computes them by
default: every grouped stack with xyz takes the source-projected first layer
(ogc_tpu/nn/flowstep3d.py:179-232, on for every dtype in eval unless
``OGC_EVAL_FOLD=off``): the first 1x1 conv is applied to the N source
points, the eval BatchNorm affine folded into it, the projections gathered,
and the centre's projection subtracted per group.  The last layer of a
multi-layer stack folds its eval BatchNorm affine and ReLU into the
neighbour pool (``_fold_bn_pool``).  Every pool is ``ops.pool_neighbors``
(#12 behind its gate).  Train mode (batch statistics, the momentum
schedule), the bf16 compute mode and InstanceNorm raise: flow training is
ROADMAP queue A.9's next part, and no flow config sets bf16 or
``use_instance_norm``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ogc_tpu_torch import ops
from ogc_tpu_torch.nn.layers import compute_dtype


def _eval_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            "FlowStep3D train mode is not ported yet (ROADMAP.md A.9, "
            "training)")
    if compute_dtype() is not None:
        raise NotImplementedError(
            "FlowStep3D in the bf16 compute mode is not ported (no flow "
            "config sets it; ROADMAP.md A.9)")


class SchedulableBatchNorm(nn.BatchNorm2d):
    """BatchNorm over every axis but the last (ogc_tpu/nn/flowstep3d.py:44),
    in eval: the reference BatchNorm2d's parameters and running statistics,
    applied channels-last."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _eval_only(self)
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias

    def eval_affine(self):
        """The eval affine (k, b) with BN(y) = y * k + b: k = weight *
        rsqrt(var + eps), b = bias - mean * k (``return_affine``)."""
        k = self.weight * torch.rsqrt(self.running_var + self.eps)
        return k, self.bias - self.running_mean * k


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True) of the reference; no config uses it."""

    def __init__(self, num_features: int):
        raise NotImplementedError(
            "use_instance_norm: InstanceNorm is not ported (no flow config "
            "sets it; ROADMAP.md open items)")


class _ConvStack(nn.Module):
    """Conv(1x1, no bias) + BatchNorm + ReLU per layer, then a max pool over
    the neighbours (flowstep3d_util.py:19-25, 84-91); ``use_act=False`` is
    conv only (:123-128)."""

    def __init__(self, in_channels: int, mlp: Sequence[int],
                 use_act: bool = True, use_instance_norm: bool = False):
        super().__init__()
        self.mlp = tuple(mlp)
        self.use_act = use_act
        chans = (in_channels,) + self.mlp
        self.mlp_convs = nn.ModuleList(
            nn.Conv2d(chans[j], chans[j + 1], 1, bias=False)
            for j in range(len(self.mlp)))
        if use_act:
            norm = InstanceNorm if use_instance_norm else SchedulableBatchNorm
            self.mlp_bns = nn.ModuleList(norm(c) for c in self.mlp)

    def _w(self, j: int) -> torch.Tensor:
        return self.mlp_convs[j].weight.flatten(1)

    @staticmethod
    def _pool(x, **kw):
        return ops.pool_neighbors(x, differentiable=False, **kw)

    def _layers(self, x: torch.Tensor, start: int) -> torch.Tensor:
        """Layers ``start``.. on a grouped (B, M, S, C) tensor, then the
        pool; the last BatchNorm layer folds into it."""
        last = len(self.mlp) - 1
        for j in range(start, len(self.mlp)):
            x = F.linear(x, self._w(j))
            if not self.use_act:
                continue
            if j == last:
                k, b = self.mlp_bns[j].eval_affine()
                return self._pool(x, scale=k, add=b, relu=True)
            x = F.relu(self.mlp_bns[j](x))
        return self._pool(x)

    def fold(self, xyz: torch.Tensor, new_xyz: torch.Tensor,
             feat: Optional[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
        """The source-projected stack (ogc_tpu/nn/flowstep3d.py:179-237):
        (B, M, mlp[-1]) from the source points xyz (B, N, 3) with ``feat``
        (B, N, C), the centres new_xyz (B, M, 3) and the neighbour table
        idx (B, M, S)."""
        _eval_only(self)
        w0 = self._w(0)
        src = xyz if feat is None else torch.cat([xyz, feat], -1)
        proj = F.linear(src, w0)
        cin = new_xyz if feat is None else torch.cat(
            [new_xyz, new_xyz.new_zeros(new_xyz.shape[:2] + feat.shape[-1:])],
            -1)
        cproj = F.linear(cin, w0)
        if self.use_act:
            k, b = self.mlp_bns[0].eval_affine()
            g = ops.group(proj * k, idx)
            cterm = b - cproj * k
        else:
            g = ops.group(proj, idx)
            cterm = -cproj
        if len(self.mlp) == 1:
            # Single-layer stacks (GRU gates, H0Net's second conv): the
            # per-group add and the activation fold into the pool.
            return self._pool(g, add=cterm, relu=self.use_act)
        x = g + cterm[:, :, None, :]
        if self.use_act:
            x = F.relu(x)
        return self._layers(x, 1)


class FlowSAModule(_ConvStack):
    """FlowStep3D set abstraction: FPS (optional, reusable indices) + KNN
    grouping (optional radius clamp) + the conv stack + max pool
    (reference PointNetSetAbstraction, utils/flowstep3d_util.py:69-138;
    ogc_tpu/nn/flowstep3d.py:273).

    :param in_channels: feature channels C of the input (without xyz).
    """

    def __init__(self, npoint: Optional[int], nsample: int,
                 mlp: Sequence[int], in_channels: int,
                 radius: Optional[float] = None, use_act: bool = True,
                 use_instance_norm: bool = False):
        super().__init__(in_channels + 3, mlp, use_act, use_instance_norm)
        self.npoint = npoint
        self.nsample = nsample
        self.radius = radius

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                fps_idx: Optional[torch.Tensor] = None,
                group_idx: Optional[torch.Tensor] = None,
                fps_nested: bool = False,
                knn_idx: Optional[torch.Tensor] = None,
                return_knn: bool = False):
        """:param xyz: (B, N, 3); :param features: (B, N, C) or None.
        :param fps_idx: reusable (B, npoint) FPS indices.
        :param group_idx: a precomputed (B, N, >= nsample) KNN table of xyz
            against itself (identity-npoint modules only); its first
            nsample columns are the neighbours.
        :param fps_nested: xyz is already in FPS selection order, so the
            sample is its first npoint points (approximate mode).
        :param knn_idx: a frozen (B, M, >= nsample) neighbour table
            replacing the KNN search (radius None).
        :return: (new_xyz (B, M, 3), new_feats (B, M, mlp[-1]), fps_idx
            [, the (B, M, nsample) neighbour table]).
        """
        if group_idx is not None:
            if return_knn or self.npoint not in (None, -1, xyz.shape[1]):
                raise ValueError("group_idx needs an identity npoint")
            out = self.fold(xyz, xyz, features,
                            group_idx[..., :self.nsample])
            return xyz, out, fps_idx
        if self.npoint not in (None, -1, xyz.shape[1]):
            if fps_idx is None and fps_nested:
                fps_idx = torch.arange(
                    self.npoint, dtype=torch.int32, device=xyz.device
                ).expand(xyz.shape[0], self.npoint)
                new_xyz = xyz[:, :self.npoint]
            else:
                if fps_idx is None:
                    fps_idx = ops.furthest_point_sample(xyz, self.npoint)
                new_xyz = ops.gather(xyz, fps_idx)
        else:
            # npoint == N: identity (ogc_tpu/nn/flowstep3d.py:386-396).
            new_xyz = xyz
        if knn_idx is not None:
            if self.radius is not None:
                raise ValueError("knn_idx carries no clamp distances")
            idx = knn_idx[..., :self.nsample]
        else:
            dist, idx = ops.knn(self.nsample, new_xyz, xyz)
            if self.radius is not None:
                idx = torch.where(dist > self.radius, idx[..., :1], idx)
        out = self.fold(xyz, new_xyz, features, idx)
        if return_knn:
            return new_xyz, out, fps_idx, idx
        return new_xyz, out, fps_idx


class FlowFPModule(nn.Module):
    """3-NN inverse-distance upsampling without an mlp (reference
    PointNetFeaturePropogation, utils/flowstep3d_util.py:141-184; every
    FlowStep3D use has mlp=[] and no target features): distances clamp at
    1e-10 (:169)."""

    @staticmethod
    def weights(pos1: torch.Tensor, pos2: torch.Tensor):
        """The 3-NN stencil (idx, weight), each (B, N, 3), of pos1 (B, N, 3)
        from pos2 (B, S, 3); a caller upsampling between fixed clouds
        computes it once."""
        dist, idx = ops.three_nn(pos1, pos2)
        w = 1.0 / torch.clamp(dist, min=1e-10)
        return idx, w / w.sum(-1, keepdim=True)

    def forward(self, pos1, pos2, feature2, cached=None):
        """:param pos1: (B, N, 3) targets; :param pos2: (B, S, 3) sources;
        :param feature2: (B, S, C); :param cached: (idx, weight) from
        ``weights``.  :return: (B, N, C)."""
        idx, w = cached if cached is not None else self.weights(pos1, pos2)
        return ops.three_interpolate(feature2, idx, w)


class FlowEmbedding(_ConvStack):
    """Cross-cloud correlation: for each point of cloud 1, its nsample KNN
    in cloud 2 (radius-clamped), the stack over [pos_diff, feat2_grouped,
    feat1] and a max pool (reference FlowEmbedding, corr_func 'concat',
    utils/flowstep3d_util.py:7-66; ogc_tpu/nn/flowstep3d.py:475 and the
    float32 path of _FlowEmbedStack)."""

    def __init__(self, radius: float, nsample: int, mlp: Sequence[int],
                 in_channels: int, use_instance_norm: bool = False):
        """:param in_channels: C2 + C1, the two clouds' feature channels."""
        super().__init__(in_channels + 3, mlp, True, use_instance_norm)
        self.radius = radius
        self.nsample = nsample

    def forward(self, pos1, pos2, feature1, feature2):
        """:param pos1, pos2: (B, N, 3); :param feature1, feature2: (B, N, C).
        :return: (pos1, (B, N, mlp[-1]))."""
        _eval_only(self)
        dist, idx = ops.knn(self.nsample, pos1, pos2)
        idx = torch.where(dist > self.radius, idx[..., :1], idx)
        g = ops.group(torch.cat([pos2, feature2], -1), idx)
        pos_diff = g[..., :3] - pos1[:, :, None, :]
        feat1 = feature1[:, :, None, :].expand(*g.shape[:3],
                                               feature1.shape[-1])
        x = F.linear(torch.cat([pos_diff, g[..., 3:], feat1], -1), self._w(0))
        x = F.relu(self.mlp_bns[0](x))
        return pos1, self._layers(x, 1)
