"""Layers of the plain reference, as functions of a parameter dict
(``P[name]``) with the reference models' state_dict names.

``Products`` carries every matrix product of the reference, so that a
control can run the same reference with its products in the precision
below the configuration's: ``TF32Products`` below float32 (with TF32
off), ``FP8Products`` below bf16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class Products:
    """Float32 products (TF32 as the process sets it)."""

    def linear(self, x, w, b=None):
        return F.linear(x, w, b)

    def bmm(self, a, b):
        return torch.bmm(a, b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, a, b)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties to even; the
    gradient passes as it is."""
    i = x.detach().float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (i.view(torch.float32) - x).detach()


class TF32Products(Products):
    """Both operands of every product rounded to TF32 first, the sums in
    float32, as the tensor cores compute with TF32 on: the control of a
    float32 configuration."""

    def linear(self, x, w, b=None):
        return F.linear(_tf32(x), _tf32(w), b)

    def bmm(self, a, b):
        return torch.bmm(_tf32(a), _tf32(b))

    def einsum(self, eq, a, b):
        return torch.einsum(eq, _tf32(a), _tf32(b))


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale to its largest
    magnitude (448, the format's largest finite value); the gradient
    passes as it is."""
    d = x.detach()
    scale = 448.0 / d.abs().amax().clamp(min=1e-30)
    return x + ((d * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
                - d)


class FP8Products(Products):
    """Both operands of every product rounded to float8 e4m3 first: the
    control of a bf16 configuration."""

    def linear(self, x, w, b=None):
        return F.linear(_fp8(x), _fp8(w), b)

    def bmm(self, a, b):
        return torch.bmm(_fp8(a), _fp8(b))

    def einsum(self, eq, a, b):
        return torch.einsum(eq, _fp8(a), _fp8(b))


def group_norm(x, weight, bias, groups: int, eps: float = 1e-5):
    """GroupNorm over the last (channel) axis of (B, ..., C): statistics per
    sample and group over every position, biased variance."""
    B, C = x.shape[0], x.shape[-1]
    xg = x.reshape(B, -1, groups, C // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * weight + bias


def layer_norm(x, weight, bias, eps: float = 1e-6):
    return F.layer_norm(x, x.shape[-1:], weight, bias, eps)


def attention(pr: Products, P, name: str, q_in, k_in, v_in, n_head: int):
    """Multi-head attention on the packed in-projection
    (``in_proj_weight``/``in_proj_bias``, ``out_proj``), queries scaled by
    1/sqrt(head size)."""
    w_q, w_k, w_v = P[name + ".in_proj_weight"].chunk(3)
    b_q, b_k, b_v = P[name + ".in_proj_bias"].chunk(3)
    B, Nq, E = q_in.shape
    hd = E // n_head

    def heads(x, w, b):
        return pr.linear(x, w, b).reshape(B, x.shape[1], n_head, hd)

    q = heads(q_in, w_q, b_q) / math.sqrt(hd)
    k = heads(k_in, w_k, b_k)
    v = heads(v_in, w_v, b_v)
    attn = torch.softmax(pr.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
    out = pr.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, Nq, E)
    return pr.linear(out, P[name + ".out_proj.weight"],
                     P[name + ".out_proj.bias"])


def mlp2(pr: Products, P, name: str, x):
    """Linear -> ReLU -> Linear (``name.0``, ``name.2``)."""
    h = F.relu(pr.linear(x, P[name + ".0.weight"], P[name + ".0.bias"]))
    return pr.linear(h, P[name + ".2.weight"], P[name + ".2.bias"])
