"""FlowStep3D's training step in plain PyTorch (float32, channels-last):
the train-mode forward over the unrolled refinement, OGC's unsupervised
flow loss, gradients by autograd and Adam, as the OGC reference's
models/flownet_ogcdr.py, losses/flow_loss_unsup.py and train_flow.py and
FlowStep3D's utils/flowstep3d_util.py describe them.

The forward is ``reference/flownet.py``'s network with BatchNorm on the
batch's statistics (biased variance, eps 1e-5, per channel over every
row), the decay ``k_decay_fact`` of training, and the two clouds encoded in
passes of their own.  The loss sums, over the refinement iterations with
the weights ``iters_w``, ``weights[0]`` x the bidirectional 1-NN Chamfer
distance between pc1 warped by the iteration's flow and pc2, and
``weights[1]`` x the flow smoothness over pc1's KNN graph (neighbours
beyond the radius replaced by the nearest) and its ball-query graph (an
under-full ball repeats its first member).  Neighbour search is
``reference/search.py``'s, in the traffic's mode.

Departures from FlowStep3D's published description, each as OGC's
training code and the program have it:
- the gradient stops where the warped cloud is carried: flow0 and its
  1/4-resolution copy where they warp pc1, and the warped clouds each
  refinement starts from; the hidden state carries it through the unroll;
- every neighbour search runs on detached points (the indices carry no
  gradient, as the reference's index-only CUDA search);
- the norms are sqrt(sum x^2) (Chamfer) and sum |x| (smoothness), and a
  zero-length Chamfer residual gives the square root's infinite slope, a
  NaN gradient;
- the approximate neighbour mode samples nested FPS prefixes and takes the
  block-min search where the searched cloud has 1024 points or more.
The running statistics are not kept: a train step never reads them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ogcbench.reference import flownet
from ogcbench.reference import search as S
from ogcbench.reference.nn import Products

#: state that is no parameter: BatchNorm's running statistics and count
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def leaves(P: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The trainable parameters of a FlowStep3D state dict."""
    return {k: v for k, v in P.items() if not k.endswith(BUFFERS)}


class _TrainNet(flownet._Net):
    def layers(self, name: str, x: torch.Tensor, n: int, act: bool):
        """Convs (and train BatchNorm + ReLU) of stack ``name`` on grouped
        rows (B, M, S, C), then the max over S (its gradient split evenly
        among tied rows)."""
        P = self.P
        for j in range(n):
            x = self.pr.linear(x, P[f"{name}.mlp_convs.{j}.weight"].flatten(1))
            if act:
                pre = f"{name}.mlp_bns.{j}"
                var, mean = torch.var_mean(x.reshape(-1, x.shape[-1]), dim=0,
                                           correction=0)
                x = ((x - mean) * torch.rsqrt(var + flownet.BN_EPS)
                     * P[pre + ".weight"] + P[pre + ".bias"])
                x = F.relu(x)
        return x.amax(2)

    def forward(self, pc1, pc2, iters: int) -> List[torch.Tensor]:
        a = self.a
        pc1_l, f1_loc, fps1, _ = self.encode_loc(pc1, pc1)
        pc2_l, f2_loc, _, _ = self.encode_loc(pc2, pc2)
        pc1_g, f1g = self.encode_glob(pc1_l[-1], f1_loc)
        pc2_g, f2g = self.encode_glob(pc2_l[-1], f2_loc)
        corr = self.global_corr(pc1_g, pc2_g, f1g, f2g)
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
        pc1_new = pc1 + flows[0].detach()
        pc1_new_lr = pc1_lr + flow0_lr.detach()
        k_decay = self.cfg["flownet"]["k_decay_fact"]
        for it in range(iters - 1):
            pc1_new, pc1_new_lr = pc1_new.detach(), pc1_new_lr.detach()
            flow_lr = pc1_new_lr - pc1_lr
            new_l, f1_new, _, _ = self.encode_loc(pc1_new, pc1_new, fps1)
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


def forward(P, cfg: dict, pc1: torch.Tensor, pc2: torch.Tensor, iters: int,
            search: S.Search, pr: Products = Products()) -> List[torch.Tensor]:
    """Each iteration's flow (B, N, 3) of pc1 towards pc2, in train mode,
    differentiable in ``P``'s parameters."""
    return _TrainNet(P, cfg, search, pr).forward(pc1, pc2, iters)


def _norm(x: torch.Tensor, ord: int) -> torch.Tensor:
    if ord == 2:
        return torch.sqrt((x * x).sum(-1))
    if ord == 1:
        return x.abs().sum(-1)
    return (x.abs() ** ord).sum(-1) ** (1.0 / ord)


def chamfer(pc1, pc2, flow, search: S.Search, loss_norm: int):
    warped = pc1 + flow
    held = warped.detach()
    _, i1 = search.knn(1, held, pc2)
    d1 = _norm(warped - S.group(pc2, i1)[:, :, 0], loss_norm)
    _, i2 = search.knn(1, pc2, held)
    d2 = _norm(pc2 - S.group(warped, i2)[:, :, 0], loss_norm)
    return (d1 + d2).mean()


def smooth_graphs(pc, cfg: dict, search: S.Search):
    """pc's KNN graph (radius-clamped) and ball-query graph."""
    s = cfg["smooth_loss_params"]
    kp, bp = s["knn_loss_params"], s["ball_q_loss_params"]
    dist, idx = search.knn(kp["k"], pc, pc)
    idx = torch.where(dist > kp["radius"], idx[..., :1], idx)
    return idx, search.ball(bp["radius"], bp["k"], pc, pc)


def smooth(flow, graphs, cfg: dict):
    s = cfg["smooth_loss_params"]
    out = 0.0
    for idx, w, p in zip(graphs, (s["w_knn"], s["w_ball_q"]),
                         (s["knn_loss_params"], s["ball_q_loss_params"])):
        diff = flow[:, :, None, :] - S.group(flow, idx)
        out = out + w * _norm(diff, p["loss_norm"]).mean()
    return out


def flow_loss(pc1, pc2, flows: List[torch.Tensor], cfg: dict,
              search: S.Search) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {chamfer_loss_#i, smooth_loss_#i}) over the iterations."""
    graphs = smooth_graphs(pc1, cfg, search)
    total, terms = 0.0, {}
    for i, (w, flow) in enumerate(zip(cfg["iters_w"], flows)):
        ch = chamfer(pc1, pc2, flow, search,
                     cfg["chamfer_loss_params"]["loss_norm"])
        sm = smooth(flow, graphs, cfg)
        terms[f"chamfer_loss_#{i}"], terms[f"smooth_loss_#{i}"] = ch, sm
        total = total + w * (cfg["weights"][0] * ch + cfg["weights"][1] * sm)
    return total, terms
