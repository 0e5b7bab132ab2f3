"""Row-group pooling of grouped neighbour features: the CUDA kernel
(csrc/pool.cu) and its plain PyTorch version.

Replaces ogc_tpu/ops/pallas_pool.py::_pool_kernel (entry points
``rowgroup_pool`` and ``pool_neighbors``):

    out[g] = reduce_s act(x[g * S + s] * scale + add[g])     act = relu | id

over fixed groups of S consecutive rows, reduce = max or mean, with the eval
BatchNorm affine (``scale``, a broadcast ``add``) or the source-projected
grouping's per-group centre term (a per-group ``add``) folded in.

Gate, as the JAX package reads it: ``OGC_PALLAS_POOL`` (default ``off``) at
import, or ``set_pool_mode``.  With ``on``, ``pool_neighbors`` routes a
non-differentiable call on a CUDA tensor of a ``supported`` shape to the
kernel; ``interpret`` routes it to ``rowgroup_pool`` on any device (on the
CPU that is the plain version: the CPU tests' way through the model's glue,
as the JAX package's interpret mode).  Everything else takes the plain chain
of pallas_pool.py:97-109 in the input's dtype.  ``supported`` is copied so
that the port launches where the JAX package would; its power-of-two S,
8-aligned group blocks and VMEM bound are TPU layout limits the CUDA kernel
does not need.

``rowgroup_pool`` routes by the tensor's device: a CPU tensor takes
``rowgroup_pool_plain``; a CUDA tensor launches the kernel or raises.
``rowgroup_pool.launches`` counts kernel launches.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ogc_tpu_torch.ops import _build

_MODE = os.environ.get("OGC_PALLAS_POOL", "off")


def set_pool_mode(mode: str) -> None:
    """Set the gate: ``off``, ``on`` or ``interpret``."""
    global _MODE
    if mode not in ("off", "on", "interpret"):
        raise ValueError(f"pool mode must be off, on or interpret: {mode!r}")
    _MODE = mode


def _pick_g(n_groups: int, s: int) -> int:
    """pallas_pool.py::_pick_g: the largest group count per block with
    G * S <= 1024 rows, G | n_groups and G a multiple of 8."""
    g = max(8, (1024 // max(s, 1)) // 8 * 8)
    while g > 8 and n_groups % g:
        g -= 8
    return g


def supported(n_groups: int, s: int, c: int) -> bool:
    """pallas_pool.py::supported: power-of-two S, 8-aligned group blocks,
    bounded VMEM."""
    if s & (s - 1) or s < 2:
        return False
    g = _pick_g(n_groups, s)
    if n_groups % g or g % 8:
        return False
    c_pad = -(-c // 128) * 128
    return c >= 8 and g * s * c_pad * 4 <= 4 * 2 ** 20


def _check_args(x, scale, add, s):
    R, C = x.shape
    if R % s:
        raise ValueError(f"rowgroup_pool: {R} rows in groups of {s}")
    if scale.shape != (C,):
        raise ValueError(f"rowgroup_pool: scale {tuple(scale.shape)}, want "
                         f"({C},)")
    if add.dim() != 2 or add.shape[1] != C or add.shape[0] not in (1, R // s):
        raise ValueError(f"rowgroup_pool: add {tuple(add.shape)}, want (1, "
                         f"{C}) or ({R // s}, {C})")


def rowgroup_pool_plain(x: torch.Tensor, scale: torch.Tensor,
                        add: torch.Tensor, s: int, relu: bool = True,
                        mean: bool = False) -> torch.Tensor:
    """The kernel's arithmetic: float32 ``x * scale + add`` (two roundings,
    no FMA), the activation, a max, or a sum in ascending s divided by S;
    one rounding to x's dtype at the end.

    :param x: (R, C) rows, group-major; :param scale: (C,) float32;
    :param add: (1, C) or (R / s, C) in x's dtype.  :return: (R / s, C).
    """
    _check_args(x, scale, add, s)
    R, C = x.shape
    y = x.float().reshape(R // s, s, C) * scale.float()
    y = y + add.float()[:, None, :]
    if relu:
        y = torch.clamp(y, min=0.0)
    if not mean:
        return y.amax(1).to(x.dtype)
    acc = y[:, 0]
    for j in range(1, s):
        acc = acc + y[:, j]
    # A tensor divisor: torch divides a CUDA tensor by a scalar as a
    # product with its reciprocal, which is not the rounded quotient.
    return (acc / torch.full_like(acc, float(s))).to(x.dtype)


def rowgroup_pool(x: torch.Tensor, scale: torch.Tensor, add: torch.Tensor,
                  s: int, relu: bool = True,
                  mean: bool = False) -> torch.Tensor:
    """Pool (R, C) rows by groups of ``s``: (R / s, C) in x's dtype
    (float32 or bfloat16)."""
    if x.device.type == "cpu":
        return rowgroup_pool_plain(x, scale, add, s, relu, mean)
    _check_args(x, scale, add, s)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rowgroup_pool: x dtype {x.dtype}")
    if scale.dtype != torch.float32 or add.dtype != x.dtype:
        raise ValueError(f"rowgroup_pool: scale {scale.dtype} (want "
                         f"float32), add {add.dtype} (want {x.dtype})")
    for name, t in (("scale", scale), ("add", add)):
        if t.device != x.device:
            raise ValueError(f"rowgroup_pool: {name} on {t.device}")
    R, C = x.shape
    n_groups = R // s
    x, scale, add = x.contiguous(), scale.contiguous(), add.contiguous()
    out = torch.empty((n_groups, C), dtype=x.dtype, device=x.device)
    if n_groups * C == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.lib().ogc_rowgroup_pool(
        x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
        add.data_ptr(), int(add.shape[0] != 1), n_groups, s, C, int(relu),
        int(mean), out.data_ptr(), stream)
    _build.check(err, "ogc_rowgroup_pool")
    rowgroup_pool.launches += 1
    return out


rowgroup_pool.launches = 0


def pool_neighbors(x: torch.Tensor, mean: bool = False,
                   differentiable: bool = True,
                   scale: Optional[torch.Tensor] = None,
                   add: Optional[torch.Tensor] = None,
                   relu: bool = False) -> torch.Tensor:
    """Reduce grouped features (B, M, S, C) over S, with an optional
    per-channel ``scale`` (C,), an ``add`` (C,) or per-group (B, M, C), and
    a ReLU before the reduce: (B, M, C) in x's dtype
    (pallas_pool.py::pool_neighbors)."""
    b, m, s, c = x.shape
    if (not differentiable and _MODE != "off"
            and (x.is_cuda or _MODE == "interpret")
            and supported(b * m, s, c)):
        sc = (torch.ones((c,), dtype=torch.float32, device=x.device)
              if scale is None else scale.float())
        if add is None:
            ad = torch.zeros((1, c), dtype=x.dtype, device=x.device)
        elif add.dim() == 1:
            ad = add.reshape(1, c).to(x.dtype)
        else:
            ad = add.reshape(b * m, c).to(x.dtype)
        out = rowgroup_pool(x.reshape(b * m * s, c), sc, ad, s, relu=relu,
                            mean=mean)
        return out.reshape(b, m, c)
    y = x
    if scale is not None:
        y = y * scale.to(y.dtype)
    if add is not None:
        y = y + (add if add.dim() == 1 else add[:, :, None, :]).to(y.dtype)
    if relu:
        y = torch.clamp(y, min=0.0)
    if mean:
        return y.float().mean(2).to(y.dtype)
    return y.amax(2)
