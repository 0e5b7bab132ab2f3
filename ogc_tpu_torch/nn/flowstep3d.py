"""FlowStep3D building blocks, channels-last (counterpart of
ogc_tpu/nn/flowstep3d.py).

KNN-grouped set abstraction with BatchNorm or InstanceNorm, cross-cloud
FlowEmbedding correlation and MLP-free feature propagation (reference
utils/flowstep3d_util.py).  Parameter names and shapes follow the reference
state_dict: ``mlp_convs.{j}.weight`` (C_out, C_in, 1, 1) and
``mlp_bns.{j}.{weight,bias,running_mean,running_var,num_batches_tracked}``
(InstanceNorm: ``weight`` and ``bias``), so reference checkpoints load
unchanged, in either compute dtype.

As the JAX package computes them.  Eval: every grouped stack with xyz takes
the source-projected first layer (ogc_tpu/nn/flowstep3d.py:179-237, in
every dtype unless ``OGC_EVAL_FOLD=off`` or with InstanceNorm): the first
1x1 conv is applied to the N source points, the eval BatchNorm affine folded
into it, the projections (cast to the compute dtype) gathered, and the
centre's projection subtracted per group.  The last layer of a stack folds
its eval BatchNorm affine and ReLU into the neighbour pool; every eval pool
is ``ops.pool_neighbors`` (#12 behind its gate).  The other eval
BatchNorm + ReLU layers, and the first layer's centre term + ReLU, are one
``ops.affine_relu`` pass each, in place, when no gradient is needed (the
CUDA kernel on the card; on the CPU the eager chain it replaces).  With no
gradient recorded, the BatchNorm's eval operands and the bf16 casts of the
conv weights are kept between calls until an in-place update or a new
storage changes what they are made from (``_kept``).  Train
(``module.train()``): BatchNorm on batch statistics, and a ``torch.amax``
pool, whose gradient splits evenly among tied rows as ``jnp.max``'s does
(the radius clamp duplicates rows, so ties are common); in float32 the
first layer takes the reference-shaped grouped tensor (relative xyz, then
features), in bf16 the raw-gather split (``W raw - W center``, :238-247).
BatchNorm takes its momentum from ``set_bn_momentum`` (the trainer's
schedule).

The bf16 compute mode (``nn.layers.compute_dtype``): every product that
touches raw coordinates (the first layer's, in every form) runs in float32
and is cast after it; later layers run in bf16, the norms normalise in bf16
from float32 statistics, and the pools run in bf16 before the float32 cast
(:80-121, :268-271).  InstanceNorm (``use_instance_norm``) skips the eval
fold and the pool folds, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ogc_tpu_torch import ops
from ogc_tpu_torch.nn.layers import (compute_dtype, form_enabled,
                                     raw_split_inputs, to_compute)
from ogc_tpu_torch.ops import remat
from ogc_tpu_torch.parallel import mesh


def _grad_needed(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _kept(owner: nn.Module, key, sources: Sequence[torch.Tensor], make):
    """``make()``, kept on ``owner`` under ``key`` while no gradient is
    recorded through ``sources`` and each of them keeps its storage and
    version counter (an in-place update moves the counter; one through
    ``.data`` does not, and nothing here updates so): an eval forward would
    otherwise rebuild these small tensors of its parameters, a launch or
    more each, at every layer of every call."""
    if _grad_needed(*sources):
        return make()
    try:
        stamp = tuple((t.data_ptr(), t._version) for t in sources)
    except RuntimeError:  # inference tensors keep no version counter
        return make()
    kept = owner.__dict__.setdefault("_kept", {})
    hit = kept.get(key)
    if hit is None or hit[0] != stamp:
        hit = kept[key] = (stamp, make())
    return hit[1]


def _operands(dtype, mean, var, eps, weight, bias):
    """The normalisation's operands (mean, rsqrt(var + eps), weight, bias),
    each cast to ``dtype``."""
    return (mean.to(dtype), torch.rsqrt(var + eps).to(dtype),
            weight.to(dtype), bias.to(dtype))


def _affine(x, mean, var, eps, weight, bias):
    """(x - mean) * rsqrt(var + eps) * weight + bias in x's dtype, each
    operand cast to it (the JAX package's normalisation)."""
    m, r, w, b = _operands(x.dtype, mean, var, eps, weight, bias)
    return (x - m) * r * w + b


class SchedulableBatchNorm(nn.BatchNorm2d):
    """BatchNorm over every axis but the last (ogc_tpu/nn/flowstep3d.py:44)
    on the reference BatchNorm2d's parameters and running statistics,
    applied channels-last, normalising in the input's dtype.

    Train: batch statistics in float32 (or the input's wider dtype),
    normalised with the biased variance; the running statistics move
    torch-style, ``(1 - m) * run + m * batch``, with the unbiased variance
    (:103-107) and the momentum m the trainer set (``set_bn_momentum``),
    except in a remat recompute (the forward moved them).
    With ``sync = "global"`` under data parallelism the statistics are the
    global batch's, in two passes (:95-113): the mean averaged over ranks,
    then the second moment centred on that mean averaged over ranks (not
    E[x^2] - E[x]^2, which cancels on a low-variance channel), both
    differentiable, and the unbiased variance over n x W rows."""

    #: "local" (each rank's batch statistics) or "global"
    sync = "local"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return _affine(x, self.running_mean, self.running_var, self.eps,
                           self.weight, self.bias)
        if self.momentum is None:
            raise ValueError("SchedulableBatchNorm needs a momentum "
                             "(set_bn_momentum), not a cumulative average")
        xf = x.reshape(-1, x.shape[-1])
        xf = xf.to(torch.promote_types(xf.dtype, torch.float32))
        n = xf.shape[0]
        ranks = mesh.world()[1] if self.sync == "global" else 1
        if ranks > 1:
            mean = mesh.mean_over_ranks(xf.mean(0))
            var = mesh.mean_over_ranks((xf - mean).square().mean(0))
            n *= ranks
        else:
            var, mean = torch.var_mean(xf, dim=0, correction=0)
        if not remat.recomputing():
            with torch.no_grad():
                f = (np.float64 if self.running_mean.dtype == torch.float64
                     else np.float32)
                m = f(self.momentum)
                keep = float(f(1) - m)
                self.running_mean.copy_(keep * self.running_mean
                                        + float(m) * mean)
                self.running_var.copy_(
                    keep * self.running_var
                    + float(m) * (var * n / max(n - 1, 1)))
                self.num_batches_tracked.add_(1)
        return _affine(x, mean, var, self.eps, self.weight, self.bias)

    def _sources(self):
        return self.weight, self.bias, self.running_mean, self.running_var

    def eval_affine(self):
        """The eval affine (k, b) with BN(y) = y * k + b: k = weight *
        rsqrt(var + eps), b = bias - mean * k (``return_affine``)."""
        def make():
            k = self.weight * torch.rsqrt(self.running_var + self.eps)
            return k, self.bias - self.running_mean * k
        return _kept(self, ("affine", self.eps), self._sources(), make)

    def eval_operands(self, dtype: torch.dtype):
        """The eval forward's operands in ``dtype``, as ``_affine`` takes
        them: the channel form of ``ops.affine_relu``."""
        return _kept(self, (dtype, self.eps), self._sources(),
                     lambda: _operands(dtype, self.running_mean,
                                       self.running_var, self.eps,
                                       self.weight, self.bias))


def set_bn_momentum(model: nn.Module, momentum: float) -> None:
    """The torch momentum of every SchedulableBatchNorm in ``model`` (the
    reference's BNMomentumScheduler, utils/pytorch_util.py:112-137)."""
    for m in model.modules():
        if isinstance(m, SchedulableBatchNorm):
            m.momentum = float(momentum)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True) of the reference, channels-last
    (ogc_tpu/nn/flowstep3d.py:124-143): per sample and channel, statistics
    in float32 over every axis but the first and the last (biased
    variance), normalised in the input's dtype, then the affine.  The same
    in train and eval; no running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(xf, dim=tuple(range(1, x.dim() - 1)),
                                   correction=0, keepdim=True)
        return _affine(x, mean, var, self.eps, self.weight, self.bias)


class _ConvStack(nn.Module):
    """Conv(1x1, no bias) + norm + ReLU per layer, then a max pool over the
    neighbours (flowstep3d_util.py:19-25, 84-91); ``use_act=False`` is conv
    only (:123-128)."""

    #: a checkpoint of its own under ``--remat`` (ops/remat.py)
    remat_block = True

    def __init__(self, in_channels: int, mlp: Sequence[int],
                 use_act: bool = True, use_instance_norm: bool = False):
        super().__init__()
        self.mlp = tuple(mlp)
        self.use_act = use_act
        self.inorm = use_instance_norm
        chans = (in_channels,) + self.mlp
        self.mlp_convs = nn.ModuleList(
            nn.Conv2d(chans[j], chans[j + 1], 1, bias=False)
            for j in range(len(self.mlp)))
        if use_act:
            norm = InstanceNorm if use_instance_norm else SchedulableBatchNorm
            self.mlp_bns = nn.ModuleList(norm(c) for c in self.mlp)

    def _w(self, j: int) -> torch.Tensor:
        return self.mlp_convs[j].weight.flatten(1)

    def _w_compute(self, j: int) -> torch.Tensor:
        """Layer j's weight in the compute dtype (the cast kept while the
        weight stays and no gradient is recorded)."""
        w = self._w(j)
        dt = compute_dtype()
        if dt is None:
            return w
        return _kept(self, ("w", j, dt), (w,), lambda: w.to(dt))

    def _dense(self, x: torch.Tensor, j: int) -> torch.Tensor:
        """Layer j's product in the compute dtype (``nn.Dense(dtype=
        compute_dtype())``)."""
        return F.linear(to_compute(x), self._w_compute(j))

    @staticmethod
    def _pool(x, **kw):
        return ops.pool_neighbors(x, differentiable=False, **kw)

    def _norm_relu(self, x: torch.Tensor, j: int) -> torch.Tensor:
        """ReLU of layer j's norm of x.  An eval BatchNorm with no gradient
        needed is one ``ops.affine_relu`` pass, in place (x is the layer's
        fresh product); train mode, InstanceNorm or a gradient take the
        chain."""
        bn = self.mlp_bns[j]
        if (isinstance(bn, SchedulableBatchNorm) and not bn.training
                and not _grad_needed(x, bn.weight, bn.bias)):
            return ops.affine_relu(x, channel=bn.eval_operands(x.dtype),
                                   inplace=True)
        return F.relu(bn(x))

    @staticmethod
    def _add_relu(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """relu(g + t[:, :, None, :]) of the grouped rows g (B, M, S, C) and
        a per-group term t (B, M, C): one ``ops.affine_relu`` pass over g in
        place (a fresh gather) when no gradient is needed."""
        if not _grad_needed(g, t):
            return ops.affine_relu(g, rows=t, inplace=True)
        return F.relu(g + t[:, :, None, :])

    def _layers(self, x: torch.Tensor, start: int,
                product: bool = True) -> torch.Tensor:
        """Layers ``start``.. on a grouped (B, M, S, C) tensor (layer
        ``start``'s product already taken unless ``product``), then the
        pool and the float32 cast; in eval with BatchNorm the last layer's
        affine and ReLU fold into the pool, in train the pool is
        ``torch.amax``."""
        last = len(self.mlp) - 1
        for j in range(start, len(self.mlp)):
            if product or j > start:
                x = self._dense(x, j)
            if not self.use_act:
                continue
            if j == last and not self.training and not self.inorm:
                k, b = self.mlp_bns[j].eval_affine()
                return ops.widen(self._pool(x, scale=k, add=b, relu=True))
            x = self._norm_relu(x, j)
        if self.training:
            return ops.widen(torch.amax(x, 2))
        return ops.widen(self._pool(x))

    def stack(self, xyz: torch.Tensor, new_xyz: torch.Tensor,
              feat: Optional[torch.Tensor], idx: torch.Tensor,
              split=None) -> torch.Tensor:
        """(B, M, mlp[-1]) from the source points xyz (B, N, 3) with
        ``feat`` (B, N, C), the centres new_xyz (B, M, 3) and the neighbour
        table idx (B, M, S), in the form FlowSAModule._grouped_inputs picks
        (ogc_tpu/nn/flowstep3d.py:291-322): ``fold`` in eval; the raw-gather
        split in bf16 (``split``: a caller's shared ``raw_split_inputs``);
        else the reference-shaped grouped tensor."""
        if split is None and not self.training and not self.inorm \
                and form_enabled("OGC_EVAL_FOLD"):
            return self.fold(xyz, new_xyz, feat, idx)
        if split is None and compute_dtype() is not None and feat is not None:
            split = raw_split_inputs(xyz, new_xyz, feat, idx)
        if split is not None:
            raw, center_in = split
            w0 = self._w(0)
            x = F.linear(raw, w0) - F.linear(center_in, w0)[:, :, None, :]
            return self._layers(to_compute(x), 0, product=False)
        grouped, _ = ops.group_with_idx(xyz, new_xyz, idx, feat)
        return self._layers(grouped, 0)

    def fold(self, xyz: torch.Tensor, new_xyz: torch.Tensor,
             feat: Optional[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
        """The source-projected stack (ogc_tpu/nn/flowstep3d.py:179-237):
        (B, M, mlp[-1]) from the source points xyz (B, N, 3) with ``feat``
        (B, N, C), the centres new_xyz (B, M, 3) and the neighbour table
        idx (B, M, S).  The projections are float32 (scene-scale xyz); the
        gathered rows and the centre term are in the compute dtype."""
        w0 = self._w(0)
        src = xyz if feat is None else torch.cat([xyz, feat], -1)
        proj = F.linear(src, w0)
        cin = new_xyz if feat is None else torch.cat(
            [new_xyz, new_xyz.new_zeros(new_xyz.shape[:2] + feat.shape[-1:])],
            -1)
        cproj = F.linear(cin, w0)
        if self.use_act:
            k, b = self.mlp_bns[0].eval_affine()
            g = ops.group(to_compute(proj * k), idx)
            cterm = to_compute(b - cproj * k)
        else:
            g = ops.group(to_compute(proj), idx)
            cterm = to_compute(-cproj)
        if len(self.mlp) == 1:
            # Single-layer stacks (GRU gates, H0Net's second conv): the
            # per-group add and the activation fold into the pool.
            return ops.widen(self._pool(g, add=cterm, relu=self.use_act))
        if self.use_act:
            x = self._add_relu(g, cterm)
        else:
            x = g + cterm[:, :, None, :]
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
                return_knn: bool = False, split=None):
        """:param xyz: (B, N, 3); :param features: (B, N, C) or None.
        :param fps_idx: reusable (B, npoint) FPS indices.
        :param group_idx: a precomputed (B, N, >= nsample) KNN table of xyz
            against itself (identity-npoint modules only); its first
            nsample columns are the neighbours.
        :param fps_nested: xyz is already in FPS selection order, so the
            sample is its first npoint points (approximate mode).
        :param knn_idx: a frozen (B, M, >= nsample) neighbour table
            replacing the KNN search (radius None).
        :param split: a ``raw_split_inputs`` of (xyz, features,
            group_idx) shared with another module (the GRU's convz / convr
            in bf16 training); only with group_idx.
        :return: (new_xyz (B, M, 3), new_feats (B, M, mlp[-1]), fps_idx
            [, the (B, M, nsample) neighbour table]).
        """
        if group_idx is not None:
            if return_knn or self.npoint not in (None, -1, xyz.shape[1]):
                raise ValueError("group_idx needs an identity npoint")
            out = self.stack(xyz, xyz, features,
                             group_idx[..., :self.nsample], split)
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
        out = self.stack(xyz, new_xyz, features, idx)
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
    utils/flowstep3d_util.py:7-66; ogc_tpu/nn/flowstep3d.py:475 and
    _FlowEmbedStack).  float32: the reference-shaped tensor.  bf16: the
    first layer by column blocks of its weight, W = [W_pos | W_f2 | W_f1]
    (:541-659): in eval with BatchNorm cloud 2's rows are projected before
    the gather with the eval affine folded in (``fold_src``), in train (or
    with InstanceNorm) the gathered rows are; the feat1 / pos1 terms are
    per point.  Those products run in float32 and are cast after them."""

    def __init__(self, radius: float, nsample: int, mlp: Sequence[int],
                 in_channels: int, use_instance_norm: bool = False):
        """:param in_channels: C2 + C1, the two clouds' feature channels."""
        super().__init__(in_channels + 3, mlp, True, use_instance_norm)
        self.radius = radius
        self.nsample = nsample

    def forward(self, pos1, pos2, feature1, feature2):
        """:param pos1, pos2: (B, N, 3); :param feature1, feature2: (B, N, C).
        :return: (pos1, (B, N, mlp[-1]))."""
        dist, idx = ops.knn(self.nsample, pos1, pos2)
        idx = torch.where(dist > self.radius, idx[..., :1], idx)
        w0 = self._w(0)
        c2 = 3 + feature2.shape[-1]
        if compute_dtype() is None:
            g = ops.group(torch.cat([pos2, feature2], -1), idx)
            pos_diff = g[..., :3] - pos1[:, :, None, :]
            feat1 = feature1[:, :, None, :].expand(*g.shape[:3],
                                                   feature1.shape[-1])
            x = F.linear(torch.cat([pos_diff, g[..., 3:], feat1], -1), w0)
            x = self._norm_relu(x, 0)
            return pos1, self._layers(x, 1)
        point = (F.linear(feature1, w0[:, c2:])
                 - F.linear(pos1, w0[:, :3]))
        if not self.training and not self.inorm:
            proj2 = F.linear(torch.cat([pos2, feature2], -1), w0[:, :c2])
            k, b = self.mlp_bns[0].eval_affine()
            gp = ops.group(to_compute(proj2 * k), idx)
            x = self._add_relu(gp, to_compute(point * k + b))
            return pos1, self._layers(x, 1)
        g = ops.group(torch.cat([pos2, feature2], -1), idx)
        x = to_compute(F.linear(g, w0[:, :c2]) + point[:, :, None, :])
        x = self._norm_relu(x, 0)
        return pos1, self._layers(x, 1)
