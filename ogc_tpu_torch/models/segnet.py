"""MaskFormer3D: PointNet++ encoder/decoder + MaskFormer head emitting K soft
object masks (counterpart of ogc_tpu/models/segnet.py).

The mask is the softmax over K of the cosine similarity between per-point
embeddings and object slots at temperature 0.05 (reference
models/segnet_sapien.py:77-80), computed in float32.  Submodule names follow
the reference state_dict (``SA_modules``, ``FP_modules``, ``MF_head``,
``object_mlp``), so ``load_state_dict`` takes a reference checkpoint or the
output of ``ogc_tpu_torch.utils.params.segnet_state_dict_from_jax``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ogc_tpu_torch import ops
from ogc_tpu_torch.nn.layers import Conv1x1, PointwiseConv
from ogc_tpu_torch.nn.pointnet2 import FPModule, SAModuleMSG
from ogc_tpu_torch.nn.transformer import MaskFormerHead, MultiheadAttention

GN_GROUPS = 4


@dataclasses.dataclass(frozen=True)
class SAStage:
    npoint_div: int  # npoint = n_point // npoint_div
    radii: Tuple[Optional[float], ...]
    nsamples: Tuple[int, ...]
    mlps: Tuple[Tuple[int, ...], ...]  # output channels per layer per scale


@dataclasses.dataclass(frozen=True)
class SegNetArch:
    sa_stages: Tuple[SAStage, ...]
    fp_mlps: Tuple[Tuple[int, ...], ...]  # index 0 = shallowest level


# Per-dataset architectures (reference models/segnet_{sapien,ogcdr,kitti}.py).
ARCHS = {
    # segnet_sapien.py:26-43 -- n_point=512, radii .1/.2/.4
    "sapien": SegNetArch(
        sa_stages=(
            SAStage(2, (0.1, 0.2), (64, 64), ((64, 64, 64), (64, 64, 128))),
            SAStage(4, (0.4,), (64,), ((128, 128, 256),)),
        ),
        fp_mlps=((128, 128, 64), (256, 128)),
    ),
    # segnet_ogcdr.py:26-43 -- n_point=2048, radii .05/.1/.2
    "ogcdr": SegNetArch(
        sa_stages=(
            SAStage(2, (0.05, 0.1), (64, 64), ((64, 64, 64), (64, 64, 128))),
            SAStage(4, (0.2,), (64,), ((128, 128, 256),)),
        ),
        fp_mlps=((128, 128, 64), (256, 128)),
    ),
    # segnet_kitti.py:26-52 -- n_point=8192, 3 SA levels, radii 1/2/4/8
    "kitti": SegNetArch(
        sa_stages=(
            SAStage(4, (1.0, 2.0), (64, 64), ((32, 32, 32), (32, 32, 64))),
            SAStage(8, (4.0,), (64,), ((64, 64, 128),)),
            SAStage(16, (8.0,), (64,), ((128, 128, 256),)),
        ),
        fp_mlps=((64, 64, 64), (64, 64), (128, 128)),
    ),
}
ARCHS["waymo"] = ARCHS["kitti"]
ARCHS["ogcdrsv"] = ARCHS["ogcdr"]
ARCHS["kittisf"] = ARCHS["kitti"]
ARCHS["kittidet"] = ARCHS["kitti"]
ARCHS["semantickitti"] = ARCHS["kitti"]


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Redraw every parameter from ``generator`` with the reference inits:
    kaiming-normal convs, torch-default linears, xavier attention
    projections, unit-normal query embeddings, unit/zero norms."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv1x1):
                nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                        nonlinearity="relu",
                                        generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                         generator=generator)
                bound = 1.0 / math.sqrt(m.in_features)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
            elif isinstance(m, MultiheadAttention):
                nn.init.xavier_uniform_(m.in_proj_weight, generator=generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, generator=generator)
        for m in model.modules():  # after the linears: out_proj bias is zero
            if isinstance(m, MultiheadAttention):
                m.out_proj.bias.zero_()


class MaskFormer3D(nn.Module):
    """3D object segmentation network: PointNet++ + MaskFormer.

    :param arch: dataset key into ARCHS or a SegNetArch.
    :param generator: draws the initial weights (reference inits); None keeps
        torch's global-RNG draws.
    """

    def __init__(self, n_slot: int, n_point: int = 512, arch="sapien",
                 use_xyz: bool = True, n_transformer_layer: int = 2,
                 transformer_embed_dim: int = 256,
                 transformer_input_pos_enc: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        arch = ARCHS[arch] if isinstance(arch, str) else arch
        level_ch = [3]  # point_feats are the xyz
        sa = []
        for stage in arch.sa_stages:
            m = SAModuleMSG(n_point // stage.npoint_div, stage.radii,
                            stage.nsamples, stage.mlps, level_ch[-1],
                            GN_GROUPS, use_xyz)
            sa.append(m)
            level_ch.append(m.out_channels)
        self.SA_modules = nn.ModuleList(sa)
        fp = []
        for j, mlp in enumerate(arch.fp_mlps):
            known = (arch.fp_mlps[j + 1][-1] if j + 1 < len(arch.fp_mlps)
                     else level_ch[j + 1])
            fp.append(FPModule(known + level_ch[j], mlp, GN_GROUPS))
        self.FP_modules = nn.ModuleList(fp)
        E = transformer_embed_dim
        self.MF_head = MaskFormerHead(
            n_slot, input_dim=level_ch[-1],
            n_transformer_layer=n_transformer_layer,
            transformer_embed_dim=E, transformer_n_head=8,
            transformer_hidden_dim=E, input_pos_enc=transformer_input_pos_enc)
        self.object_mlp = nn.Sequential(
            PointwiseConv(E, E, GN_GROUPS, conv_dims=1),
            PointwiseConv(E, 64, None, act=False, conv_dims=1))
        if generator is not None:
            init_parameters(self, generator)

    def forward(self, pc: torch.Tensor,
                point_feats: torch.Tensor) -> torch.Tensor:
        """:param pc: (B, N, 3); :param point_feats: (B, N, 3).
        :return: mask (B, N, K)."""
        # From stage 1 on, approximate mode samples a prefix of the previous
        # stage's FPS output (nested FPS, ogc_tpu/models/segnet.py:110-127).
        nested = not ops.exact_neighbors()
        l_pc, l_feats = [pc], [point_feats]
        for si, sa in enumerate(self.SA_modules):
            new_xyz, new_feats = sa(l_pc[-1], l_feats[-1],
                                    fps_nested=nested and si > 0)
            l_pc.append(new_xyz)
            l_feats.append(new_feats)
        # Decoder, deepest level first (segnet_sapien.py:67-70).
        n_fp = len(self.FP_modules)
        for i in range(-1, -(n_fp + 1), -1):
            l_feats[i - 1] = self.FP_modules[n_fp + i](
                l_pc[i - 1], l_pc[i], l_feats[i - 1], l_feats[i])
        # The head runs in float32 whatever the compute dtype; object_mlp
        # follows it, as in the JAX package.
        slot = self.object_mlp(self.MF_head(l_feats[-1].float(), l_pc[-1]))
        feats = F.normalize(l_feats[0].float(), dim=-1, eps=1e-12)
        slot = F.normalize(slot.float(), dim=-1, eps=1e-12)
        logits = torch.einsum("bnd,bkd->bnk", feats, slot) / 0.05
        return torch.softmax(logits, dim=-1)
