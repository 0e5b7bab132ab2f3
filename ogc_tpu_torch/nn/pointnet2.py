"""PointNet++ set abstraction and feature propagation, channels-last
(counterpart of ogc_tpu/nn/pointnet2.py).

SA = FPS -> KNN grouping with a per-scale radius clamp -> SharedMLP -> max
over the neighbourhood; FP = three_nn inverse-distance interpolation +
SharedMLP (reference utils/pointnet2_util.py:9-121).  This is the
reference-shaped chain, i.e. what the JAX package computes with
OGC_EVAL_FOLD=off; the JAX package's source-projected eval fold differs from
it by matmul reassociation only (~1e-6).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ogc_tpu_torch import ops
from ogc_tpu_torch.nn.layers import SharedMLP


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (PointnetSAModuleMSG).

    :param in_channels: feature channels C of the input (without xyz).
    :param mlps: output channels per layer, one tuple per scale.
    """

    def __init__(self, npoint: int, radii: Sequence[Optional[float]],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 in_channels: int, num_groups: Optional[int] = None,
                 use_xyz: bool = True):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.use_xyz = use_xyz
        cin = in_channels + (3 if use_xyz else 0)
        self.mlps = nn.ModuleList(
            SharedMLP(cin, mlp, num_groups) for mlp in mlps)
        self.out_channels = sum(mlp[-1] for mlp in mlps)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:param xyz: (B, N, 3); :param features: (B, N, C) or None.
        :return: (new_xyz (B, npoint, 3), new_features (B, npoint, sum out))."""
        new_xyz = ops.gather(xyz, ops.furthest_point_sample(xyz, self.npoint))
        # One KNN serves every scale: the scales share nsample and differ only
        # in the clamp radius, and a smaller nsample is a sorted prefix.
        dist, idx = ops.knn(max(self.nsamples), new_xyz, xyz)
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            i = idx[..., :nsample]
            if radius is not None:
                i = torch.where(dist[..., :nsample] > radius, i[..., :1], i)
            grouped, _ = ops.group_with_idx(xyz, new_xyz, i, features,
                                            self.use_xyz)
            outs.append(mlp(grouped).amax(dim=2))
        return new_xyz, torch.cat(outs, -1)


class SAModule(SAModuleMSG):
    """Single-scale set abstraction (utils/pointnet2_util.py:76-88)."""

    def __init__(self, npoint: int, radius: Optional[float], nsample: int,
                 mlp: Sequence[int], in_channels: int,
                 num_groups: Optional[int] = None, use_xyz: bool = True):
        super().__init__(npoint, (radius,), (nsample,), (tuple(mlp),),
                         in_channels, num_groups, use_xyz)


class FPModule(nn.Module):
    """Feature propagation: 3-NN interpolation + SharedMLP (PointnetFPModule).

    :param in_channels: known_feats channels + unknown_feats channels.
    """

    def __init__(self, in_channels: int, mlp: Sequence[int],
                 num_groups: Optional[int] = None):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp, num_groups)

    def forward(self, unknown: torch.Tensor, known: torch.Tensor,
                unknown_feats: Optional[torch.Tensor],
                known_feats: torch.Tensor) -> torch.Tensor:
        """:param unknown: (B, N, 3); :param known: (B, M, 3);
        :param unknown_feats: (B, N, C1) or None; :param known_feats: (B, M, C2).
        :return: (B, N, mlp[-1])."""
        idx, weight = ops.interpolate_weights(unknown, known)
        x = ops.three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            x = torch.cat([x, unknown_feats], -1)
        return self.mlp(x)
