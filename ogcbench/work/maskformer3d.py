"""The matmul and 1x1-conv FLOPs of one MaskFormer3D forward
(2 x rows x in x out a product), from the configuration's widths: the SA
stages' grouped rows, the FP stages, the MaskFormer head (projections and
attention products) and the final slot-point product."""

from __future__ import annotations

from typing import List, Tuple


def _stack(rows: int, cin: int, chans) -> float:
    f = 0.0
    for c in chans:
        f += 2.0 * rows * cin * c
        cin = c
    return f


def forward_flops(cfg: dict, clouds: int) -> List[Tuple[float, str]]:
    """[(FLOPs, precision)] of a forward over ``clouds`` clouds."""
    arch, sn = cfg["arch"], cfg["segnet"]
    N = sn["n_point"]
    E, K, H = sn["transformer_embed_dim"], sn["n_slot"], 64
    f = 0.0
    pts, ch = [N], [3]
    for st in arch["sa_stages"]:
        m = N // st["npoint_div"]
        for ns, mlp in zip(st["nsamples"], st["mlps"]):
            f += _stack(clouds * m * ns, ch[-1] + 3, mlp)
        pts.append(m)
        ch.append(sum(mlp[-1] for mlp in st["mlps"]))
    fp = arch["fp_mlps"]
    for j, mlp in enumerate(fp):
        known = fp[j + 1][-1] if j + 1 < len(fp) else ch[j + 1]
        f += _stack(clouds * pts[j], known + ch[j], mlp)
    M = pts[-1]
    f += _stack(clouds * M, ch[-1], (E, E))            # mlp_input
    for _ in range(sn["n_transformer_layer"]):
        f += 2.0 * clouds * (K * E * E + 2 * M * E * E + K * E * E)  # cross
        f += 2.0 * 2 * clouds * K * M * E                # scores, values
        f += 2.0 * clouds * 4 * K * E * E                # self q, k, v, out
        f += 2.0 * 2 * clouds * K * K * E
        f += 2.0 * 2 * clouds * K * E * E                # the MLP
    f += _stack(clouds * K, E, (E, H))                   # object_mlp
    f += 2.0 * clouds * N * K * H                        # slots x points
    return [(f, "f32")]
