"""PointNet++ set abstraction and feature propagation, channels-last
(counterpart of ogc_tpu/nn/pointnet2.py).

SA = FPS -> KNN grouping with a per-scale radius clamp -> SharedMLP -> max
over the neighbourhood (ops.pool_neighbors, #12 behind its gate); FP =
three_nn inverse-distance interpolation + SharedMLP (reference
utils/pointnet2_util.py:9-121).

The first layer of a grouped stack with features and a norm takes the JAX
package's forms in every compute dtype (ogc_tpu/nn/pointnet2.py:225-406),
its products in float32 on the coordinates: in eval the source-projected
fold (every scale's first layer projects the SOURCE points, the projections,
cast to the compute dtype, are gathered once, and the centre's projection
is subtracted from the gathered rows), which differs from the
reference-shaped chain by the order of float32 sums only (~1e-6); in
training the split: the first product in float32, cast to the compute dtype
after it.  The port's split takes the product of the centred rows, where
the JAX package's takes W raw - W centre: that form's gradient in the xyz
columns is a difference of two sums of raw coordinates, and it moved the
validation terms of tests/test_torch_dp.py's two-rank train_seg epoch
6.3e-3 from the JAX CLI's (the smooth term), against 1e-4 for the centred
rows.  In float32 the split is therefore the reference-shaped product; in
bf16 it keeps the float32 product that the reference shape
(``OGC_TRAIN_SPLIT=off``: SharedMLP on the centred rows in the compute
dtype) gives up.  ``OGC_EVAL_FOLD=off`` restores the reference-shaped eval
chain.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ogc_tpu_torch import ops
from ogc_tpu_torch.nn.layers import SharedMLP, form_enabled, to_compute


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (PointnetSAModuleMSG).

    :param in_channels: feature channels C of the input (without xyz).
    :param mlps: output channels per layer, one tuple per scale.
    """

    #: a checkpoint of its own under ``--remat`` (ops/remat.py)
    remat_block = True

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
        # The fold and the split need a norm after the first product (no
        # bias), as the JAX package's do.
        forms = (features is not None and self.use_xyz
                 and self.num_groups is not None)
        if forms and not self.training and form_enabled("OGC_EVAL_FOLD"):
            return new_xyz, self._fold(xyz, new_xyz, features, dist, idx)
        split = forms and self.training and form_enabled("OGC_TRAIN_SPLIT")
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            i = idx[..., :nsample]
            if radius is not None:
                i = torch.where(dist[..., :nsample] > radius, i[..., :1], i)
            grouped, _ = ops.group_with_idx(xyz, new_xyz, i, features,
                                            self.use_xyz)
            if split:
                # The first product in float32 on the centred rows, cast
                # to the compute dtype after it.
                h = F.linear(ops.widen(grouped),
                             mlp.layer0.conv.weight.flatten(1))
                h = mlp.rest(mlp.layer0.post(to_compute(h)))
            else:
                h = mlp(grouped)
            outs.append(ops.pool_neighbors(h, differentiable=self.training))
        return new_xyz, torch.cat(outs, -1)

    def _fold(self, xyz, new_xyz, features, dist, idx):
        """The eval fold: every scale's first product applied to the source
        points in float32, one gather of the projections (in the compute
        dtype), the radius clamp as a row select, the centre term
        subtracted in the compute dtype."""
        w = torch.cat([m.layer0.conv.weight.flatten(1) for m in self.mlps])
        proj = F.linear(ops.widen(torch.cat([xyz, features], -1)), w)
        cproj = to_compute(F.linear(ops.widen(new_xyz), w[:, :3]))
        g = ops.group(to_compute(proj), idx)  # (B, M, k_max, sum c0)
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

    remat_block = True

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
