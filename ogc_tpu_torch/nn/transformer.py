"""MaskFormer-style transformer head (counterpart of ogc_tpu/nn/transformer.py).

Reference utils/transformer_util.py: a decoder layer runs cross-attention,
then self-attention, then an MLP, each pre-normed with a residual; the head
holds K learned queries.  Attention is written out as matmul + softmax in
float32 with flax's 1/sqrt(head_dim) query scaling.  LayerNorm eps is 1e-6,
flax's default, which the JAX package uses.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ogc_tpu_torch.nn.layers import MLP

LN_EPS = 1e-6


class MultiheadAttention(nn.Module):
    """Multi-head attention with torch nn.MultiheadAttention's parameter
    names (packed ``in_proj_weight``/``in_proj_bias``, ``out_proj``)."""

    def __init__(self, embed_dim: int, n_head: int):
        super().__init__()
        if embed_dim % n_head:
            raise ValueError(f"embed_dim {embed_dim} not divisible by {n_head}")
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor,
                v_in: torch.Tensor) -> torch.Tensor:
        """(B, Nq, E), (B, Nk, E), (B, Nk, E) -> (B, Nq, E)."""
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)
        B, Nq, E = q_in.shape
        hd = E // self.n_head

        def heads(x, w, b):
            return F.linear(x, w, b).reshape(B, x.shape[1], self.n_head, hd)

        q = heads(q_in, w_q, b_q) / math.sqrt(hd)
        k = heads(k_in, w_k, b_k)
        v = heads(v_in, w_v, b_v)
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, Nq, E)
        return self.out_proj(out)


class TransformerDecoderLayer(nn.Module):
    """Cross-attention + self-attention decoder layer
    (utils/transformer_util.py:5-59)."""

    def __init__(self, embed_dim: int = 256, n_head: int = 8,
                 hidden_dim: int = 256):
        super().__init__()
        self.norm_slot1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.cross_attn = MultiheadAttention(embed_dim, n_head)
        self.norm_slot2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.self_attn = MultiheadAttention(embed_dim, n_head)
        self.norm_pre_ff = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.mlp = MLP(embed_dim, hidden_dim, embed_dim)

    def forward(self, slot: torch.Tensor, point_feats: torch.Tensor,
                pos_enc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:param slot: (B, K, C); :param point_feats: (B, N, C);
        :param pos_enc: optional (B, N, C) added to the keys only."""
        keys = point_feats + pos_enc if pos_enc is not None else point_feats
        slot = slot + self.cross_attn(self.norm_slot1(slot), keys, point_feats)
        s2 = self.norm_slot2(slot)
        slot = slot + self.self_attn(s2, s2, s2)
        return slot + self.mlp(self.norm_pre_ff(slot))


class MaskFormerHead(nn.Module):
    """K learned queries refined by decoder layers
    (utils/transformer_util.py:62-121)."""

    #: a checkpoint of its own under ``--remat`` (ops/remat.py)
    remat_block = True

    def __init__(self, n_slot: int, input_dim: int = 256,
                 n_transformer_layer: int = 2, transformer_embed_dim: int = 256,
                 transformer_n_head: int = 8, transformer_hidden_dim: int = 256,
                 input_pos_enc: bool = False):
        super().__init__()
        E = transformer_embed_dim
        self.query = nn.Embedding(n_slot, E)
        self.mlp_input = MLP(input_dim, E, E)
        self.norm_input = nn.LayerNorm(E, eps=LN_EPS)
        self.input_pos_enc = nn.Linear(3, E) if input_pos_enc else None
        self.transformer_layers = nn.ModuleList(
            TransformerDecoderLayer(E, transformer_n_head,
                                    transformer_hidden_dim)
            for _ in range(n_transformer_layer))

    def forward(self, point_feats: torch.Tensor,
                point_pos: torch.Tensor) -> torch.Tensor:
        """:param point_feats: (B, N, C_in); :param point_pos: (B, N, 3).
        :return: slots (B, K, E)."""
        B = point_feats.shape[0]
        slot = self.query.weight[None].expand(B, -1, -1)
        inputs = self.norm_input(self.mlp_input(point_feats))
        pos_enc = (self.input_pos_enc(point_pos)
                   if self.input_pos_enc is not None else None)
        for layer in self.transformer_layers:
            slot = layer(slot, inputs, pos_enc)
        return slot
