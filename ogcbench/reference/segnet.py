"""MaskFormer3D in plain PyTorch (float32, channels-last), as the OGC
reference's models/segnet_kitti.py describes it: a PointNet++ encoder
(multi-scale grouping: FPS, KNN with a per-scale radius clamp, shared
1x1 convs with GroupNorm and ReLU, max over the neighbours), a decoder of
3-NN inverse-distance interpolation and shared MLPs, and a MaskFormer head
(learned slot queries through cross-attention, self-attention and an MLP,
each pre-normed with a residual) whose slots meet the per-point embeddings
by cosine similarity at temperature 0.05, softmax over the slots.

In the approximate neighbour mode every SA stage after the first samples a
prefix of the previous stage's FPS output (nested FPS), as the configured
search does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ogcbench.reference import search as S
from ogcbench.reference.nn import (Products, attention, group_norm,
                                   layer_norm, mlp2)


def _shared_mlp(pr: Products, P, name: str, x, n_layers: int, groups: int):
    for j in range(n_layers):
        pre = f"{name}.layer{j}"
        x = pr.linear(x, P[pre + ".conv.weight"].flatten(1))
        x = F.relu(group_norm(x, P[pre + ".normlayer.gn.weight"],
                              P[pre + ".normlayer.gn.bias"], groups))
    return x


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the configuration's MaskFormer3D, by name."""
    arch, sn = cfg["arch"], cfg["segnet"]
    shapes: Dict[str, Tuple[int, ...]] = {}
    level_ch = [3]
    for si, st in enumerate(arch["sa_stages"]):
        for j, mlp in enumerate(st["mlps"]):
            stack_shapes(shapes, f"SA_modules.{si}.mlps.{j}",
                         level_ch[-1] + 3, mlp)
        level_ch.append(sum(m[-1] for m in st["mlps"]))
    fp = arch["fp_mlps"]
    for j, mlp in enumerate(fp):
        known = fp[j + 1][-1] if j + 1 < len(fp) else level_ch[j + 1]
        stack_shapes(shapes, f"FP_modules.{j}.mlp", known + level_ch[j], mlp)
    E, K = sn["transformer_embed_dim"], sn["n_slot"]
    h = "MF_head"
    shapes[h + ".query.weight"] = (K, E)
    shapes[h + ".mlp_input.0.weight"] = (E, level_ch[-1])
    shapes[h + ".mlp_input.0.bias"] = (E,)
    shapes[h + ".mlp_input.2.weight"] = (E, E)
    shapes[h + ".mlp_input.2.bias"] = (E,)
    shapes[h + ".norm_input.weight"] = (E,)
    shapes[h + ".norm_input.bias"] = (E,)
    for t in range(sn["n_transformer_layer"]):
        pre = f"{h}.transformer_layers.{t}"
        for n in ("norm_slot1", "norm_slot2", "norm_pre_ff"):
            shapes[f"{pre}.{n}.weight"] = (E,)
            shapes[f"{pre}.{n}.bias"] = (E,)
        for n in ("cross_attn", "self_attn"):
            shapes[f"{pre}.{n}.in_proj_weight"] = (3 * E, E)
            shapes[f"{pre}.{n}.in_proj_bias"] = (3 * E,)
            shapes[f"{pre}.{n}.out_proj.weight"] = (E, E)
            shapes[f"{pre}.{n}.out_proj.bias"] = (E,)
        shapes[f"{pre}.mlp.0.weight"] = (E, E)
        shapes[f"{pre}.mlp.0.bias"] = (E,)
        shapes[f"{pre}.mlp.2.weight"] = (E, E)
        shapes[f"{pre}.mlp.2.bias"] = (E,)
    shapes["object_mlp.0.conv.weight"] = (E, E, 1)
    shapes["object_mlp.0.normlayer.gn.weight"] = (E,)
    shapes["object_mlp.0.normlayer.gn.bias"] = (E,)
    shapes["object_mlp.1.conv.weight"] = (64, E, 1)
    shapes["object_mlp.1.conv.bias"] = (64,)
    return shapes


def stack_shapes(shapes, name, cin, chans):
    """The shapes of a shared MLP of 1x1 Conv2d + GroupNorm layers."""
    for j, c in enumerate(chans):
        pre = f"{name}.layer{j}"
        shapes[pre + ".conv.weight"] = (c, cin, 1, 1)
        shapes[pre + ".normlayer.gn.weight"] = (c,)
        shapes[pre + ".normlayer.gn.bias"] = (c,)
        cin = c


def forward(P, cfg: dict, pc: torch.Tensor, search: S.Search,
            pr: Products = Products()) -> torch.Tensor:
    """:param pc: (B, N, 3) clouds (also the point features).
    :return: masks (B, N, K)."""
    arch, sn = cfg["arch"], cfg["segnet"]
    G, n_point = arch["gn_groups"], sn["n_point"]
    nested = not search.exact
    l_pc: List[torch.Tensor] = [pc]
    l_f: List[torch.Tensor] = [pc]
    for si, st in enumerate(arch["sa_stages"]):
        xyz, feats = l_pc[-1], l_f[-1]
        npoint = n_point // st["npoint_div"]
        if nested and si > 0:
            new_xyz = xyz[:, :npoint]
        else:
            new_xyz = S.gather(xyz, S.fps(xyz, npoint))
        dist, idx = search.knn(max(st["nsamples"]), new_xyz, xyz)
        src = torch.cat([xyz, feats], -1)
        outs = []
        for j, (radius, ns, mlp) in enumerate(
                zip(st["radii"], st["nsamples"], st["mlps"])):
            i = idx[..., :ns]
            if radius is not None:
                i = torch.where(dist[..., :ns] > radius, i[..., :1], i)
            g = S.group(src, i)
            grouped = torch.cat([g[..., :3] - new_xyz[:, :, None, :],
                                 g[..., 3:]], -1)
            h = _shared_mlp(pr, P, f"SA_modules.{si}.mlps.{j}", grouped,
                            len(mlp), G)
            outs.append(h.amax(2))
        l_pc.append(new_xyz)
        l_f.append(torch.cat(outs, -1))
    n_fp = len(arch["fp_mlps"])
    for i in range(-1, -(n_fp + 1), -1):
        unknown, known = l_pc[i - 1], l_pc[i]
        dist, idx = search.knn(3, unknown, known)
        recip = 1.0 / (dist + 1e-8)
        w = recip / recip.sum(-1, keepdim=True)
        x = (S.group(l_f[i], idx) * w[..., None]).sum(2)
        x = torch.cat([x, l_f[i - 1]], -1)
        j = n_fp + i
        l_f[i - 1] = _shared_mlp(pr, P, f"FP_modules.{j}.mlp", x,
                                 len(arch["fp_mlps"][j]), G)
    # MaskFormer head on the deepest level.
    h = "MF_head"
    B = pc.shape[0]
    slot = P[h + ".query.weight"][None].expand(B, -1, -1)
    inputs = layer_norm(mlp2(pr, P, h + ".mlp_input", l_f[-1]),
                        P[h + ".norm_input.weight"], P[h + ".norm_input.bias"])
    for t in range(sn["n_transformer_layer"]):
        pre = f"{h}.transformer_layers.{t}"

        def ln(n, x):
            return layer_norm(x, P[f"{pre}.{n}.weight"], P[f"{pre}.{n}.bias"])

        slot = slot + attention(pr, P, pre + ".cross_attn",
                                ln("norm_slot1", slot), inputs, inputs,
                                arch["n_head"])
        s2 = ln("norm_slot2", slot)
        slot = slot + attention(pr, P, pre + ".self_attn", s2, s2, s2,
                                arch["n_head"])
        slot = slot + mlp2(pr, P, pre + ".mlp", ln("norm_pre_ff", slot))
    x = pr.linear(slot, P["object_mlp.0.conv.weight"].flatten(1))
    x = F.relu(group_norm(x, P["object_mlp.0.normlayer.gn.weight"],
                          P["object_mlp.0.normlayer.gn.bias"], G))
    slot = pr.linear(x, P["object_mlp.1.conv.weight"].flatten(1),
                     P["object_mlp.1.conv.bias"])
    feats = F.normalize(l_f[0], dim=-1, eps=1e-12)
    slot = F.normalize(slot, dim=-1, eps=1e-12)
    logits = pr.einsum("bnd,bkd->bnk", feats, slot) / 0.05
    return torch.softmax(logits, dim=-1)
