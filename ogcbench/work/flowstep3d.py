"""The matmul and 1x1-conv FLOPs of one FlowStep3D eval forward over B
pairs (2 x rows x in x out a product), from the configuration's widths:
both clouds' encoders, the all-pairs correlation and its decoder, flow0,
and each refinement's encoder, local correlation, flow convs, GRU and
regressor.  Each product is tagged with its precision in the cell's
compute mode: in bf16 the first product of every stack (it touches the
coordinates), the correlation and the linear heads stay float32."""

from __future__ import annotations

from typing import List, Tuple


def forward_flops(cfg: dict, B: int, iters: int, compute: str = "f32"
                  ) -> List[Tuple[float, str]]:
    a, N = cfg["arch"], cfg["flownet"]["npoint"]
    rest = "bf16" if compute == "bf16" else "f32"
    out: List[Tuple[float, str]] = []

    def stack(clouds, m, ns, cin, mlp):
        rows = clouds * m * ns
        cin += 3
        for j, c in enumerate(mlp):
            out.append((2.0 * rows * cin * c, "f32" if j == 0 else rest))
            cin = c

    def sa(clouds, spec, cin, ns=None):
        stack(clouds, N // spec["npoint_div"], ns or spec["nsample"], cin,
              spec["mlp"])
        return spec["mlp"][-1]

    def encode_loc(clouds):
        c = 3
        for s in a["enc_loc"]:
            c = sa(clouds, s, c)
        return c

    c_loc = encode_loc(2 * B)
    c = c_loc
    for s in a["enc_glob"]:
        c = sa(2 * B, s, c)
    m = N // a["enc_glob"][-1]["npoint_div"]
    out.append((2.0 * B * m * m * (3 + c + 3), "f32"))   # d2, cosine, soft flow
    c = 3
    for s in a["corr_sa"]:
        c = sa(B, s, c)
    lr = N // 4
    reg = {"npoint_div": 4, "nsample": a["reg_nsample"], "mlp": a["reg_mlp"]}
    gate = {"npoint_div": 4, "nsample": 4, "mlp": [a["hidden_dim"]]}
    sa(B, reg, a["corr_dim"])
    out.append((2.0 * B * lr * a["reg_mlp"][-1] * 3, "f32"))
    sa(B, {"npoint_div": 4, "nsample": 4, "mlp": a["h0_mlp1"]}, c_loc)
    sa(B, gate, a["h0_mlp1"][-1])
    x_dim = c_loc + a["local_corr_mlp"][-1] + a["flow_conv2"]["mlp"][-1] + 3
    for _ in range(iters - 1):
        encode_loc(B)
        stack(B, lr, cfg["flownet"]["loc_flow_nn"], 2 * c_loc,
              a["local_corr_mlp"])
        sa(B, a["flow_conv1"], 3)
        sa(B, a["flow_conv2"], a["flow_conv1"]["mlp"][-1])
        for _ in range(3):
            sa(B, gate, a["hidden_dim"] + x_dim)
        sa(B, reg, a["hidden_dim"])
        sa(B, reg, a["reg_mlp"][-1])
        out.append((2.0 * B * lr * a["reg_mlp"][-1] * 3, "f32"))
    return out
