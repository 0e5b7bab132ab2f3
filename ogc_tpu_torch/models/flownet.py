"""FlowStep3D, the recurrent scene-flow network (counterpart of
ogc_tpu/models/flownet.py).

One config-parameterized model for the reference's per-dataset copies
(models/flownet_{sapien,ogcdr,kitti}.py).  Pipeline (flownet_kitti.py:
209-252): local encoders on both clouds -> global encoders -> all-pairs
kernelized softmax correlation -> flow0 at 1/4 resolution -> upsample; then
iters - 1 GRU refinement steps: re-encode the warped cloud (reusing frame
1's FPS indices), local FlowEmbedding correlation, GRU update, delta-flow
regression with k_decay damping, upsample and accumulate.

As the JAX package computes it: one KNN table of the 1/4-resolution cloud
against itself serves every module that groups it; the upsample stencil is
computed once.  Eval encodes both clouds in one 2B batch; in the
approximate neighbour mode the nested FPS samples prefixes and the warped
cloud's self-KNN tables are frozen across the refinement (freeze_knn); the
exact mode recomputes them per iteration.  Train encodes pc1, then pc2, in
passes of their own, so that each BatchNorm sees (and updates its running
statistics from) one cloud at a time in the JAX package's order
(ogc_tpu/models/flownet.py:376-389); it never freezes the self-KNN tables,
and the gradient stops where the JAX package's does: at flow0 and flow0_lr
where they warp the clouds (:452-455) and at the carried clouds each
iteration starts from (:462-463).  The JAX package's ``nn.scan`` over the
refinement is a Python loop here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from ogc_tpu_torch import ops
from ogc_tpu_torch.nn.flowstep3d import (FlowEmbedding, FlowFPModule,
                                         FlowSAModule)


@dataclasses.dataclass(frozen=True)
class SASpec:
    npoint_div: int
    nsample: int
    mlp: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class FlowNetArch:
    """Per-dataset hyperparameters (diffs of models/flownet_*.py)."""

    enc_loc: Tuple[SASpec, ...]
    enc_glob: Tuple[SASpec, ...]
    # Global corr decoder: alternating FP-upsample and SA stages walking the
    # glob pyramid back to the 1/4-resolution level.
    corr_sa: Tuple[SASpec, ...]
    corr_dim: int  # output channels of the corr feature chain
    reg_nsample: int
    reg_mlp: Tuple[int, ...]
    hidden_dim: int
    local_corr_mlp: Tuple[int, ...]
    flow_conv1: SASpec
    flow_conv2: SASpec
    h0_mlp1: Tuple[int, ...]


ARCHS = {
    # models/flownet_sapien.py (npoint=512)
    "sapien": FlowNetArch(
        enc_loc=(SASpec(2, 16, (32, 32, 32)), SASpec(4, 16, (64, 64, 64))),
        enc_glob=(SASpec(8, 16, (128, 128, 128)),
                  SASpec(16, 8, (256, 256, 256))),
        corr_sa=(SASpec(8, 8, (32, 64, 128)),),
        corr_dim=128,
        reg_nsample=16,
        reg_mlp=(128, 128, 128),
        hidden_dim=128,
        local_corr_mlp=(128, 128, 128),
        flow_conv1=SASpec(4, 8, (32, 32, 32)),
        flow_conv2=SASpec(4, 4, (16, 16, 16)),
        h0_mlp1=(128, 128, 128),
    ),
    # models/flownet_ogcdr.py (npoint=2048)
    "ogcdr": FlowNetArch(
        enc_loc=(SASpec(2, 16, (32, 32, 32)), SASpec(4, 16, (64, 64, 64))),
        enc_glob=(SASpec(8, 16, (128, 128, 128)),
                  SASpec(16, 8, (128, 128, 128))),
        corr_sa=(SASpec(8, 8, (32, 64, 64)),),
        corr_dim=64,
        reg_nsample=16,
        reg_mlp=(64, 64, 64),
        hidden_dim=64,
        local_corr_mlp=(64, 64, 64),
        flow_conv1=SASpec(4, 8, (32, 32, 32)),
        flow_conv2=SASpec(4, 4, (16, 16, 16)),
        h0_mlp1=(64, 64, 64),
    ),
    # models/flownet_kitti.py (npoint=8192): 3-level global encoder and a
    # deeper corr decoder.
    "kitti": FlowNetArch(
        enc_loc=(SASpec(2, 32, (32, 32, 32)), SASpec(4, 32, (64, 64, 64))),
        enc_glob=(
            SASpec(8, 32, (128, 128, 128)),
            SASpec(16, 24, (128, 128, 128)),
            SASpec(32, 16, (256, 256, 256)),
        ),
        corr_sa=(SASpec(16, 16, (32, 32, 64)), SASpec(8, 16, (64, 64, 128))),
        corr_dim=128,
        reg_nsample=32,
        reg_mlp=(128, 128, 128),
        hidden_dim=128,
        local_corr_mlp=(128, 128, 128),
        flow_conv1=SASpec(4, 16, (32, 32, 32)),
        flow_conv2=SASpec(4, 8, (16, 16, 16)),
        h0_mlp1=(128, 128, 128),
    ),
}
# ogcdrsv shares the ogcdr flownet; waymo uses the kitti flownet.
ARCHS["ogcdrsv"] = ARCHS["ogcdr"]
ARCHS["waymo"] = ARCHS["kitti"]
ARCHS["kittisf"] = ARCHS["kitti"]


class GlobalCorrLayer(nn.Module):
    """Kernelized softmax correlation at the coarsest level, then the FP/SA
    chain back to the 1/4-resolution level (GlobalCorrLayer.forward)."""

    def __init__(self, npoint: int, a: FlowNetArch, inorm: bool):
        super().__init__()
        self.epsilon = nn.Parameter(torch.zeros(1))
        cin = 3  # the soft-argmax flow
        for i, s in enumerate(a.corr_sa):
            self.add_module(f"sa{i + 1}", FlowSAModule(
                npoint // s.npoint_div, s.nsample, s.mlp, cin,
                use_instance_norm=inorm))
            cin = s.mlp[-1]
        self.n_sa = len(a.corr_sa)
        self.fp = FlowFPModule()

    def corr_mat(self, pc1, pc2, f1, f2):
        """exp(-(1 - cos(f1, f2)) / eps) masked to a 10 m support
        (flownet_kitti.py:53-65)."""
        eps = torch.exp(self.epsilon) + 0.03
        d2 = ((pc1 ** 2).sum(-1, keepdim=True)
              + (pc2 ** 2).sum(-1, keepdim=True).transpose(1, 2)
              - 2.0 * torch.bmm(pc1, pc2.transpose(1, 2)))
        support = (d2 < 10.0 ** 2).to(f1.dtype)
        f1 = f1 * torch.rsqrt((f1 ** 2).sum(-1, keepdim=True) + 1e-8)
        f2 = f2 * torch.rsqrt((f2 ** 2).sum(-1, keepdim=True) + 1e-8)
        c = 1.0 - torch.bmm(f1, f2.transpose(1, 2))
        return torch.exp(-c / eps) * support

    def forward(self, pc1_l, pc2_l, f1, f2):
        p1, p2 = pc1_l[-1], pc2_l[-1]
        corr = self.corr_mat(p1, p2, f1, f2)
        row_sum = corr.sum(-1, keepdim=True)
        feats = torch.bmm(corr, p2) / (row_sum + 1e-8) - p1
        level = len(pc1_l) - 1
        for i in range(self.n_sa):
            feats = self.fp(pc1_l[level - 1], pc1_l[level], feats)
            _, feats, _ = getattr(self, f"sa{i + 1}")(pc1_l[level - 1], feats)
            level -= 1
        return self.fp(pc1_l[level - 1], pc1_l[level], feats)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Redraw the convs and linears from ``generator`` with torch's default
    inits (kaiming-uniform, a = sqrt(5); linear biases uniform in +-1 /
    sqrt(fan_in)), as the reference's modules are built."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                         generator=generator)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    nn.init.uniform_(m.bias, -bound, bound,
                                     generator=generator)


class FlowStep3D(nn.Module):
    """:param npoint: points per cloud; :param arch: dataset key into ARCHS.
    :param generator: draws the initial weights (torch's default inits);
        None keeps torch's global-RNG draws.
    State_dict keys are the reference's (models/flownet_*.py)."""

    def __init__(self, npoint: int = 512, arch: str = "sapien",
                 use_instance_norm: bool = False, loc_flow_nn: int = 8,
                 loc_flow_rad: float = 0.1, k_decay_fact: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        a = ARCHS[arch] if isinstance(arch, str) else arch
        self.arch = a
        self.k_decay_fact = k_decay_fact
        inorm = use_instance_norm

        def sa(spec, cin, **kw):
            return FlowSAModule(npoint // spec.npoint_div, spec.nsample,
                                spec.mlp, cin, use_instance_norm=inorm, **kw)

        loc, cin = {}, 3  # the flow features are the points themselves
        for i, s in enumerate(a.enc_loc):
            loc[f"sa{i + 1}"] = sa(s, cin)
            cin = s.mlp[-1]
        c_loc = cin
        self.encoder_loc = nn.ModuleDict(loc)
        glob = {}
        for i, s in enumerate(a.enc_glob):
            glob[f"sa{i + 1}"] = sa(s, cin)
            cin = s.mlp[-1]
        self.encoder_glob = nn.ModuleDict(glob)
        self.global_corr_layer = GlobalCorrLayer(npoint, a, inorm)
        lr = SASpec(4, 4, a.h0_mlp1)
        self.h0_net = nn.ModuleDict({
            "sa1": sa(lr, c_loc),
            "sa2": sa(SASpec(4, 4, (a.hidden_dim,)), a.h0_mlp1[-1],
                      use_act=False)})
        reg = SASpec(4, a.reg_nsample, a.reg_mlp)
        self.flow0_regressor = nn.ModuleDict({
            "sa1": sa(reg, a.corr_dim), "fc": nn.Linear(a.reg_mlp[-1], 3)})
        self.flow_regressor = nn.ModuleDict({
            "sa1": sa(reg, a.hidden_dim), "sa2": sa(reg, a.reg_mlp[-1]),
            "fc": nn.Linear(a.reg_mlp[-1], 3)})
        self.local_corr_layer = FlowEmbedding(
            loc_flow_rad, loc_flow_nn, a.local_corr_mlp, 2 * c_loc, inorm)
        self.flow_conv1 = sa(a.flow_conv1, 3)
        self.flow_conv2 = sa(a.flow_conv2, a.flow_conv1.mlp[-1])
        x_dim = c_loc + a.local_corr_mlp[-1] + a.flow_conv2.mlp[-1] + 3
        gate = SASpec(4, 4, (a.hidden_dim,))
        self.gru = nn.ModuleDict({
            n: sa(gate, a.hidden_dim + x_dim, use_act=False)
            for n in ("convz", "convr", "convq")})
        self.flow_up_sample = FlowFPModule()
        if generator is not None:
            init_parameters(self, generator)

    def _encode_loc(self, pc, feature, fps_idx=None, knn_idx=None):
        """EncoderLoc: two SA levels with reusable FPS indices; level 2's
        FPS nests in level 1's order in approximate mode.  :return: ([pc,
        pc_l1, pc_l2], feats, fps indices, self-KNN tables)."""
        nested = not ops.exact_neighbors()
        sa1, sa2 = self.encoder_loc["sa1"], self.encoder_loc["sa2"]
        pc_l1, feat_l1, f1, k1 = sa1(
            pc, feature, fps_idx=None if fps_idx is None else fps_idx[0],
            knn_idx=None if knn_idx is None else knn_idx[0], return_knn=True)
        pc_l2, feat_l2, f2, k2 = sa2(
            pc_l1, feat_l1, fps_idx=None if fps_idx is None else fps_idx[1],
            fps_nested=nested,
            knn_idx=None if knn_idx is None else knn_idx[1], return_knn=True)
        return [pc, pc_l1, pc_l2], feat_l2, [f1, f2], [k1, k2]

    def _encode_glob(self, pc, feature):
        nested = not ops.exact_neighbors()
        pc_l, feats = [pc], feature
        for sa in self.encoder_glob.values():
            new_pc, feats, _ = sa(pc_l[-1], feats, fps_nested=nested)
            pc_l.append(new_pc)
        return pc_l, feats

    def _gru(self, h, x, pc, lr_idx):
        g = self.gru
        hx = torch.cat([h, x], -1)
        z = torch.sigmoid(g["convz"](pc, hx, group_idx=lr_idx)[1])
        r = torch.sigmoid(g["convr"](pc, hx, group_idx=lr_idx)[1])
        q = torch.tanh(g["convq"](pc, torch.cat([r * h, x], -1),
                                  group_idx=lr_idx)[1])
        return (1 - z) * h + z * q

    def _encode(self, pc1, pc2, feature1, feature2):
        """Both clouds through the local and global encoders: (pc1_l, pc2_l,
        feats1_loc, feats2_loc, fps_idx1, knn1, pc1_g, pc2_g, f1g, f2g)."""
        if self.training:
            pc1_l, feats1_loc, fps_idx1, _ = self._encode_loc(pc1, feature1)
            pc2_l, feats2_loc, _, _ = self._encode_loc(pc2, feature2)
            pc1_g, f1g = self._encode_glob(pc1_l[-1], feats1_loc)
            pc2_g, f2g = self._encode_glob(pc2_l[-1], feats2_loc)
            return (pc1_l, pc2_l, feats1_loc, feats2_loc, fps_idx1, None,
                    pc1_g, pc2_g, f1g, f2g)
        # Eval: running statistics, so one 2B batch encodes both clouds.
        B = pc1.shape[0]
        pc12_l, feats12, fps12, knn12 = self._encode_loc(
            torch.cat([pc1, pc2]), torch.cat([feature1, feature2]))
        # Approximate mode freezes the warped cloud's self-KNN tables.
        knn1 = None if ops.exact_neighbors() else [k[:B] for k in knn12]
        pc12_g, f12g = self._encode_glob(pc12_l[-1], feats12)
        return ([p[:B] for p in pc12_l], [p[B:] for p in pc12_l],
                feats12[:B], feats12[B:], [f[:B] for f in fps12], knn1,
                [p[:B] for p in pc12_g], [p[B:] for p in pc12_g], f12g[:B],
                f12g[B:])

    def forward(self, pc1, pc2, feature1, feature2,
                iters: int = 1) -> List[torch.Tensor]:
        """:param pc1, pc2: (B, N, 3); :param feature1, feature2: (B, N, 3).
        :return: the per-iteration flow predictions [(B, N, 3)]."""
        a = self.arch
        (pc1_l, pc2_l, feats1_loc, feats2_loc, fps_idx1, knn1, pc1_g, pc2_g,
         f1g, f2g) = self._encode(pc1, pc2, feature1, feature2)
        corr_feats = self.global_corr_layer(pc1_g, pc2_g, f1g, f2g)

        pc1_lr, pc2_lr = pc1_l[2], pc2_l[-1]
        lr_k = max(a.reg_nsample, a.flow_conv1.nsample, a.flow_conv2.nsample,
                   4)
        _, lr_idx = ops.knn(lr_k, pc1_lr, pc1_lr)
        reg0 = self.flow0_regressor
        _, x0, _ = reg0["sa1"](pc1_lr, corr_feats, group_idx=lr_idx)
        flow0_lr = reg0["fc"](x0)
        up = FlowFPModule.weights(pc1, pc1_lr)
        flow0 = self.flow_up_sample(pc1, pc1_lr, flow0_lr, cached=up)
        flows = [flow0]

        _, h, _ = self.h0_net["sa1"](pc1_lr, feats1_loc, group_idx=lr_idx)
        _, h, _ = self.h0_net["sa2"](pc1_lr, h, group_idx=lr_idx)
        h = torch.tanh(h)
        pc1_new = pc1 + flow0.detach()
        pc1_new_lr = pc1_lr + flow0_lr.detach()
        reg = self.flow_regressor
        for it in range(iters - 1):
            pc1_new, pc1_new_lr = pc1_new.detach(), pc1_new_lr.detach()
            flow_lr = pc1_new_lr - pc1_lr
            pc1_new_l, feats1_new, _, _ = self._encode_loc(
                pc1_new, pc1_new, fps_idx1, knn_idx=knn1)
            _, corr = self.local_corr_layer(pc1_new_l[-1], pc2_lr,
                                            feats1_new, feats2_loc)
            _, ff, _ = self.flow_conv1(pc1_lr, flow_lr, group_idx=lr_idx)
            _, ff, _ = self.flow_conv2(pc1_lr, ff, group_idx=lr_idx)
            x = torch.cat([feats1_new, corr, ff, flow_lr], -1)
            h = self._gru(h, x, pc1_lr, lr_idx)
            _, dx, _ = reg["sa1"](pc1_lr, h, group_idx=lr_idx)
            _, dx, _ = reg["sa2"](pc1_lr, dx, group_idx=lr_idx)
            delta_lr = reg["fc"](dx) / (self.k_decay_fact * it + 1.0)
            pc1_new_lr = pc1_new_lr + delta_lr
            pc1_new = pc1_new + self.flow_up_sample(pc1, pc1_lr, delta_lr,
                                                    cached=up)
            flows.append(pc1_new - pc1)
        return flows
