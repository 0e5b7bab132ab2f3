"""FlowStep3D's eval forward in plain PyTorch (float32, channels-last), as
the OGC reference's models/flownet_kitti.py and FlowStep3D's
utils/flowstep3d_util.py describe it.

Every set abstraction is FPS (or its reused indices), KNN grouping of
[xyz - centre, features], 1x1 convs each followed by eval BatchNorm
(running statistics) and ReLU, and a max over the neighbours; a gate stack
is one conv and the max.  Local encoders on both clouds, global encoders,
an all-pairs kernelised-softmax correlation at the coarsest level walked
back to 1/4 resolution, flow0 regressed there and upsampled by 3-NN
inverse distances; then ``iters - 1`` GRU refinements, each re-encoding the
warped cloud with frame 1's FPS indices, correlating it locally with cloud
2 (FlowEmbedding), updating the hidden state and adding a regressed delta
damped by 1 / (k_decay * it + 1).

The approximate neighbour mode samples nested FPS prefixes and freezes the
warped cloud's encoder KNN tables at those of the first encoding, as the
configured search does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ogcbench.reference import search as S
from ogcbench.reference.nn import Products

BN_EPS = 1e-5


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and buffer of the configuration's FlowStep3D."""
    a = cfg["arch"]
    shapes: Dict[str, Tuple[int, ...]] = {}

    def stack(name, cin, mlp, act=True):
        chans = [cin + 3] + list(mlp)
        for j in range(len(mlp)):
            shapes[f"{name}.mlp_convs.{j}.weight"] = (chans[j + 1], chans[j],
                                                      1, 1)
        if act:
            for j, c in enumerate(mlp):
                pre = f"{name}.mlp_bns.{j}"
                for n in ("weight", "bias", "running_mean", "running_var"):
                    shapes[f"{pre}.{n}"] = (c,)
                shapes[f"{pre}.num_batches_tracked"] = ()

    cin = 3
    for i, s in enumerate(a["enc_loc"]):
        stack(f"encoder_loc.sa{i + 1}", cin, s["mlp"])
        cin = s["mlp"][-1]
    c_loc = cin
    for i, s in enumerate(a["enc_glob"]):
        stack(f"encoder_glob.sa{i + 1}", cin, s["mlp"])
        cin = s["mlp"][-1]
    shapes["global_corr_layer.epsilon"] = (1,)
    cin = 3
    for i, s in enumerate(a["corr_sa"]):
        stack(f"global_corr_layer.sa{i + 1}", cin, s["mlp"])
        cin = s["mlp"][-1]
    stack("h0_net.sa1", c_loc, a["h0_mlp1"])
    stack("h0_net.sa2", a["h0_mlp1"][-1], [a["hidden_dim"]], act=False)
    stack("flow0_regressor.sa1", a["corr_dim"], a["reg_mlp"])
    shapes["flow0_regressor.fc.weight"] = (3, a["reg_mlp"][-1])
    shapes["flow0_regressor.fc.bias"] = (3,)
    stack("flow_regressor.sa1", a["hidden_dim"], a["reg_mlp"])
    stack("flow_regressor.sa2", a["reg_mlp"][-1], a["reg_mlp"])
    shapes["flow_regressor.fc.weight"] = (3, a["reg_mlp"][-1])
    shapes["flow_regressor.fc.bias"] = (3,)
    stack("local_corr_layer", 2 * c_loc, a["local_corr_mlp"])
    stack("flow_conv1", 3, a["flow_conv1"]["mlp"])
    stack("flow_conv2", a["flow_conv1"]["mlp"][-1], a["flow_conv2"]["mlp"])
    x_dim = c_loc + a["local_corr_mlp"][-1] + a["flow_conv2"]["mlp"][-1] + 3
    for n in ("convz", "convr", "convq"):
        stack(f"gru.{n}", a["hidden_dim"] + x_dim, [a["hidden_dim"]],
              act=False)
    return shapes


class _Net:
    def __init__(self, P, cfg: dict, search: S.Search, pr: Products):
        self.P, self.cfg, self.search, self.pr = P, cfg, search, pr
        self.a = cfg["arch"]
        self.N = cfg["flownet"]["npoint"]

    def layers(self, name: str, x: torch.Tensor, n: int, act: bool):
        """Convs (and eval BatchNorm + ReLU) of stack ``name`` on grouped
        rows (B, M, S, C), then the max over S."""
        P = self.P
        for j in range(n):
            x = self.pr.linear(x, P[f"{name}.mlp_convs.{j}.weight"].flatten(1))
            if act:
                pre = f"{name}.mlp_bns.{j}"
                x = ((x - P[pre + ".running_mean"])
                     * torch.rsqrt(P[pre + ".running_var"] + BN_EPS)
                     * P[pre + ".weight"] + P[pre + ".bias"])
                x = F.relu(x)
        return x.amax(2)

    def grouped(self, xyz, new_xyz, feats, idx):
        src = xyz if feats is None else torch.cat([xyz, feats], -1)
        g = S.group(src, idx)
        return torch.cat([g[..., :3] - new_xyz[:, :, None, :], g[..., 3:]], -1)

    def sa(self, name: str, spec: dict, xyz, feats, fps_idx=None,
           nested=False, knn_idx=None, group_idx=None, act=True):
        """(new_xyz, new_feats, fps_idx, the neighbour table)."""
        npoint = self.N // spec["npoint_div"]
        ns = spec["nsample"]
        n = len(spec["mlp"])
        if group_idx is not None:
            idx = group_idx[..., :ns]
            return xyz, self.layers(name, self.grouped(xyz, xyz, feats, idx),
                                    n, act), fps_idx, idx
        if npoint != xyz.shape[1]:
            if fps_idx is None and nested:
                fps_idx = torch.arange(npoint, device=xyz.device).expand(
                    xyz.shape[0], npoint)
                new_xyz = xyz[:, :npoint]
            else:
                if fps_idx is None:
                    fps_idx = S.fps(xyz, npoint)
                new_xyz = S.gather(xyz, fps_idx)
        else:
            new_xyz = xyz
        if knn_idx is not None:
            idx = knn_idx[..., :ns]
        else:
            _, idx = self.search.knn(ns, new_xyz, xyz)
        out = self.layers(name, self.grouped(xyz, new_xyz, feats, idx), n, act)
        return new_xyz, out, fps_idx, idx

    def encode_loc(self, pc, feats, fps_idx=None, knn_idx=None):
        nested = not self.search.exact
        s1, s2 = self.a["enc_loc"]
        p1, f1, i1, k1 = self.sa("encoder_loc.sa1", s1, pc, feats,
                                 None if fps_idx is None else fps_idx[0],
                                 knn_idx=None if knn_idx is None
                                 else knn_idx[0])
        p2, f2, i2, k2 = self.sa("encoder_loc.sa2", s2, p1, f1,
                                 None if fps_idx is None else fps_idx[1],
                                 nested=nested,
                                 knn_idx=None if knn_idx is None
                                 else knn_idx[1])
        return [pc, p1, p2], f2, [i1, i2], [k1, k2]

    def encode_glob(self, pc, feats):
        nested = not self.search.exact
        pcs = [pc]
        for i, s in enumerate(self.a["enc_glob"]):
            p, feats, _, _ = self.sa(f"encoder_glob.sa{i + 1}", s, pcs[-1],
                                     feats, nested=nested)
            pcs.append(p)
        return pcs, feats

    def up_weights(self, pos1, pos2):
        dist, idx = self.search.knn(3, pos1, pos2)
        w = 1.0 / torch.clamp(dist, min=1e-10)
        return idx, w / w.sum(-1, keepdim=True)

    @staticmethod
    def interp(feats, up):
        idx, w = up
        return (S.group(feats, idx) * w[..., None]).sum(2)

    def global_corr(self, pc1_l, pc2_l, f1, f2):
        P, pr = self.P, self.pr
        p1, p2 = pc1_l[-1], pc2_l[-1]
        eps = torch.exp(P["global_corr_layer.epsilon"]) + 0.03
        d2 = ((p1 ** 2).sum(-1, keepdim=True)
              + (p2 ** 2).sum(-1, keepdim=True).transpose(1, 2)
              - 2.0 * pr.bmm(p1, p2.transpose(1, 2)))
        support = (d2 < 10.0 ** 2).to(f1.dtype)
        f1 = f1 * torch.rsqrt((f1 ** 2).sum(-1, keepdim=True) + 1e-8)
        f2 = f2 * torch.rsqrt((f2 ** 2).sum(-1, keepdim=True) + 1e-8)
        corr = torch.exp(-(1.0 - pr.bmm(f1, f2.transpose(1, 2))) / eps) \
            * support
        feats = pr.bmm(corr, p2) / (corr.sum(-1, keepdim=True) + 1e-8) - p1
        level = len(pc1_l) - 1
        for i, s in enumerate(self.a["corr_sa"]):
            feats = self.interp(feats, self.up_weights(pc1_l[level - 1],
                                                       pc1_l[level]))
            _, feats, _, _ = self.sa(f"global_corr_layer.sa{i + 1}", s,
                                     pc1_l[level - 1], feats)
            level -= 1
        return self.interp(feats, self.up_weights(pc1_l[level - 1],
                                                  pc1_l[level]))

    def local_corr(self, pos1, pos2, f1, f2):
        fn = self.cfg["flownet"]
        dist, idx = self.search.knn(fn["loc_flow_nn"], pos1, pos2)
        idx = torch.where(dist > fn["loc_flow_rad"], idx[..., :1], idx)
        g = S.group(torch.cat([pos2, f2], -1), idx)
        x = torch.cat([g[..., :3] - pos1[:, :, None, :], g[..., 3:],
                       f1[:, :, None, :].expand(*g.shape[:3], f1.shape[-1])],
                      -1)
        return self.layers("local_corr_layer", x,
                           len(self.a["local_corr_mlp"]), True)

    def fc(self, name, x):
        return self.pr.linear(x, self.P[name + ".weight"],
                              self.P[name + ".bias"])

    def forward(self, pc1, pc2, iters: int) -> List[torch.Tensor]:
        a = self.a
        B = pc1.shape[0]
        pc12_l, f12, fps12, knn12 = self.encode_loc(torch.cat([pc1, pc2]),
                                                    torch.cat([pc1, pc2]))
        pc1_l, pc2_l = [p[:B] for p in pc12_l], [p[B:] for p in pc12_l]
        f1_loc, f2_loc = f12[:B], f12[B:]
        fps1 = [f[:B] for f in fps12]
        knn1 = None if self.search.exact else [k[:B] for k in knn12]
        pc12_g, f12g = self.encode_glob(pc12_l[-1], f12)
        corr = self.global_corr([p[:B] for p in pc12_g],
                                [p[B:] for p in pc12_g], f12g[:B], f12g[B:])
        pc1_lr, pc2_lr = pc1_l[2], pc2_l[-1]
        lr_k = max(a["reg_nsample"], a["flow_conv1"]["nsample"],
                   a["flow_conv2"]["nsample"], 4)
        _, lr_idx = self.search.knn(lr_k, pc1_lr, pc1_lr)
        reg = {"npoint_div": 4, "nsample": a["reg_nsample"],
               "mlp": a["reg_mlp"]}
        _, x0, _, _ = self.sa("flow0_regressor.sa1", reg, pc1_lr, corr,
                              group_idx=lr_idx)
        flow0_lr = self.fc("flow0_regressor.fc", x0)
        up = self.up_weights(pc1, pc1_lr)
        flows = [self.interp(flow0_lr, up)]
        _, h, _, _ = self.sa("h0_net.sa1", {"npoint_div": 4, "nsample": 4,
                                            "mlp": a["h0_mlp1"]},
                             pc1_lr, f1_loc, group_idx=lr_idx)
        gate = {"npoint_div": 4, "nsample": 4, "mlp": [a["hidden_dim"]]}
        _, h, _, _ = self.sa("h0_net.sa2", gate, pc1_lr, h, group_idx=lr_idx,
                             act=False)
        h = torch.tanh(h)
        pc1_new, pc1_new_lr = pc1 + flows[0], pc1_lr + flow0_lr
        k_decay = self.cfg["flownet"]["test_k_decay_fact"]
        for it in range(iters - 1):
            flow_lr = pc1_new_lr - pc1_lr
            new_l, f1_new, _, _ = self.encode_loc(pc1_new, pc1_new, fps1,
                                                  knn1)
            c = self.local_corr(new_l[-1], pc2_lr, f1_new, f2_loc)
            _, ff, _, _ = self.sa("flow_conv1", a["flow_conv1"], pc1_lr,
                                  flow_lr, group_idx=lr_idx)
            _, ff, _, _ = self.sa("flow_conv2", a["flow_conv2"], pc1_lr, ff,
                                  group_idx=lr_idx)
            x = torch.cat([f1_new, c, ff, flow_lr], -1)
            hx = torch.cat([h, x], -1)
            z = torch.sigmoid(self.sa("gru.convz", gate, pc1_lr, hx,
                                      group_idx=lr_idx, act=False)[1])
            r = torch.sigmoid(self.sa("gru.convr", gate, pc1_lr, hx,
                                      group_idx=lr_idx, act=False)[1])
            q = torch.tanh(self.sa("gru.convq", gate, pc1_lr,
                                   torch.cat([r * h, x], -1),
                                   group_idx=lr_idx, act=False)[1])
            h = (1 - z) * h + z * q
            _, dx, _, _ = self.sa("flow_regressor.sa1", reg, pc1_lr, h,
                                  group_idx=lr_idx)
            _, dx, _, _ = self.sa("flow_regressor.sa2", reg, pc1_lr, dx,
                                  group_idx=lr_idx)
            delta_lr = self.fc("flow_regressor.fc", dx) / (k_decay * it + 1.0)
            pc1_new_lr = pc1_new_lr + delta_lr
            pc1_new = pc1_new + self.interp(delta_lr, up)
            flows.append(pc1_new - pc1)
        return flows


@torch.no_grad()
def forward(P, cfg: dict, pc1: torch.Tensor, pc2: torch.Tensor, iters: int,
            search: S.Search, pr: Optional[Products] = None) -> torch.Tensor:
    """The last iteration's flow (B, N, 3) of pc1 towards pc2."""
    return _Net(P, cfg, search, pr or Products()).forward(pc1, pc2, iters)[-1]
