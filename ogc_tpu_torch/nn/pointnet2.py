"""PointNet++ set abstraction and feature propagation, channels-last
(counterpart of ogc_tpu/nn/pointnet2.py).

SA = FPS -> KNN grouping with a per-scale radius clamp -> SharedMLP -> max
over the neighbourhood (ops.pool_neighbors, #12 behind its gate); FP =
three_nn inverse-distance interpolation + SharedMLP (reference
utils/pointnet2_util.py:9-121).  In float32 this is the reference-shaped
chain, i.e. what the JAX package computes with OGC_EVAL_FOLD=off; the JAX
package's source-projected eval fold differs from it by matmul
reassociation only (~1e-6).

In the bf16 compute mode the first layer of each grouped stack keeps
float32 on the raw coordinates, as the JAX package places it
(ogc_tpu/nn/pointnet2.py:257-406): in training its product runs in float32
on the centred group and is cast to bf16 after the centre correction (the
split form); in eval the first layer projects the SOURCE points in float32,
the projections are cast to bf16 and gathered, and the centre's projection,
also cast, is subtracted from the gathered rows (the source-projected fold).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ogc_tpu_torch import ops
from ogc_tpu_torch.nn.layers import SharedMLP, compute_dtype


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
        self.num_groups = num_groups
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.use_xyz = use_xyz
        cin = in_channels + (3 if use_xyz else 0)
        self.mlps = nn.ModuleList(
            SharedMLP(cin, mlp, num_groups) for mlp in mlps)
        self.out_channels = sum(mlp[-1] for mlp in mlps)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                fps_nested: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:param xyz: (B, N, 3); :param features: (B, N, C) or None.
        :param fps_nested: ``xyz`` is an upstream FPS stage's output in
            selection order; greedy FPS is incremental, so this stage's
            sample is its first npoint points (approximate mode only: exact
            up to distance ties).
        :return: (new_xyz (B, npoint, 3), new_features (B, npoint, sum out))."""
        if fps_nested:
            new_xyz = xyz[:, :self.npoint]
        else:
            new_xyz = ops.gather(xyz,
                                 ops.furthest_point_sample(xyz, self.npoint))
        # One KNN serves every scale: the scales share nsample and differ only
        # in the clamp radius, and a smaller nsample is a sorted prefix.
        dist, idx = ops.knn(max(self.nsamples), new_xyz, xyz)
        # The bf16 forms need a norm after the first product (no bias),
        # as the JAX package's split and fold do.
        dt = compute_dtype() if self.num_groups is not None else None
        if dt is not None and not self.training and features is not None \
                and self.use_xyz:
            return new_xyz, self._fold(xyz, new_xyz, features, dist, idx, dt)
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            i = idx[..., :nsample]
            if radius is not None:
                i = torch.where(dist[..., :nsample] > radius, i[..., :1], i)
            grouped, _ = ops.group_with_idx(xyz, new_xyz, i, features,
                                            self.use_xyz)
            # The split form: the first product in float32, cast to the
            # compute dtype after it.
            h = F.linear(grouped.float(), mlp.layer0.conv.weight.flatten(1),
                         mlp.layer0.conv.bias)
            h = mlp.rest(mlp.layer0.post(h if dt is None else h.to(dt)))
            outs.append(ops.pool_neighbors(h, differentiable=self.training))
        return new_xyz, torch.cat(outs, -1)

    def _fold(self, xyz, new_xyz, features, dist, idx, dt):
        """The bf16 eval path: every scale's first product applied to the
        source points in float32, one gather of the bf16 projections, the
        radius clamp as a row select, the centre term subtracted in bf16."""
        w = torch.cat([m.layer0.conv.weight.flatten(1) for m in self.mlps])
        proj = F.linear(torch.cat([xyz, features], -1).float(), w)
        cproj = F.linear(new_xyz.float(), w[:, :3]).to(dt)
        g = ops.group(proj.to(dt), idx)  # (B, M, k_max, sum c0)
        outs, off = [], 0
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            c0 = mlp.layer0.conv.weight.shape[0]
            gs = g[..., :nsample, off:off + c0]
            if radius is not None:
                gs = torch.where((dist[..., :nsample] > radius)[..., None],
                                 g[..., :1, off:off + c0], gs)
            h = mlp.rest(mlp.layer0.post(gs - cproj[:, :, None, off:off + c0]))
            outs.append(ops.pool_neighbors(h, differentiable=self.training))
            off += c0
        return torch.cat(outs, -1)


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
