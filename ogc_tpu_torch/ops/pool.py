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
``rowgroup_pool.launches`` counts kernel launches.  ``pool_plan`` picks the
kernel's instance (S fixed at compile time or not; 16-byte chunks of
channels or one channel per thread).  An absent scale or add reaches the
kernel as a null pointer (a product with 1.0, a sum with +0.0), so
``pool_neighbors`` allocates nothing for it.
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
    if x.dim() != 2:
        raise ValueError(f"rowgroup_pool: x {tuple(x.shape)}, want (R, C)")
    R, C = x.shape
    if s < 1 or R % s:
        raise ValueError(f"rowgroup_pool: {R} rows in groups of {s}")
    if scale is not None and scale.shape != (C,):
        raise ValueError(f"rowgroup_pool: scale {tuple(scale.shape)}, want "
                         f"({C},)")
    if add is not None and (add.dim() != 2 or add.shape[1] != C
                            or add.shape[0] not in (1, R // s)):
        raise ValueError(f"rowgroup_pool: add {tuple(add.shape)}, want (1, "
                         f"{C}) or ({R // s}, {C})")


def rowgroup_pool_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                        add: Optional[torch.Tensor], s: int,
                        relu: bool = True,
                        mean: bool = False) -> torch.Tensor:
    """The kernel's arithmetic: float32 ``x * scale + add`` (two roundings,
    no FMA; an absent scale is 1.0, an absent add +0.0), ReLU as ``v <= 0 ?
    +0.0 : v`` (a NaN passes), a max that propagates NaN, or a sum in
    ascending s from the s = 0 value divided by S; one rounding to x's
    dtype at the end.

    :param x: (R, C) rows, group-major; :param scale: (C,) float32 or None;
    :param add: (1, C) or (R / s, C) in x's dtype, or None.
    :return: (R / s, C).
    """
    _check_args(x, scale, add, s)
    R, C = x.shape
    y = x.float().reshape(R // s, s, C) * (1.0 if scale is None
                                           else scale.float())
    y = y + (0.0 if add is None else add.float()[:, None, :])
    if relu:
        y = torch.where(y <= 0.0, 0.0, y)
    if not mean:
        return y.amax(1).to(x.dtype)
    acc = y[:, 0]
    for j in range(1, s):
        acc = acc + y[:, j]
    # A tensor divisor: torch divides a CUDA tensor by a scalar as a
    # product with its reciprocal, which is not the rounded quotient.
    return (acc / torch.full_like(acc, float(s))).to(x.dtype)


#: The S values the kernel is compiled for (csrc/pool.cu); any other S
#: takes the runtime-S instance.
COMPILED_S = (4, 8, 16, 32)


def pool_plan(s: int, c: int, itemsize: int, aligned: bool = True):
    """The kernel instance for groups of ``s`` rows of ``c`` channels of
    ``itemsize`` bytes: (S template, 0 for the runtime-S one; 16-byte
    chunks, else one channel per thread).  ``aligned``: every pointer the
    kernel reads or writes is 16-byte aligned."""
    return (s if s in COMPILED_S else 0,
            aligned and (c * itemsize) % 16 == 0)


_DTYPES = (torch.float32, torch.bfloat16)
# Bits of the C entry's flags argument (csrc/pool.cu).
_BF16, _RELU, _MEAN, _PER_GROUP, _VEC = 1, 2, 4, 8, 16


def rowgroup_pool(x: torch.Tensor, scale: Optional[torch.Tensor],
                  add: Optional[torch.Tensor], s: int, relu: bool = True,
                  mean: bool = False) -> torch.Tensor:
    """Pool (R, C) rows by groups of ``s``: (R / s, C) in x's dtype
    (float32 or bfloat16).  ``scale`` (C,) float32 and ``add`` (1 | R / s,
    C) in x's dtype may be None (1.0 and +0.0).  On the card the host path
    does only what the launch needs (the flow path's small pools take a
    few microseconds of device time): one combined check, no copy of a
    contiguous tensor, the output without deterministic mode's fill (the
    kernel writes it whole), the stream as a raw handle, one flags word."""
    if x.is_cpu:
        return rowgroup_pool_plain(x, scale, add, s, relu, mean)
    dev = x.get_device()
    shape = x.shape
    if (dev < 0 or len(shape) != 2 or x.dtype not in _DTYPES or s < 1
            or shape[0] % s
            or (scale is not None
                and (scale.get_device() != dev
                     or scale.dtype != torch.float32
                     or scale.shape != shape[1:]))
            or (add is not None
                and (add.get_device() != dev or add.dtype != x.dtype
                     or add.dim() != 2 or add.shape[1] != shape[1]
                     or add.shape[0] not in (1, shape[0] // s)))):
        _check_args(x, scale, add, s)
        raise ValueError(
            f"rowgroup_pool: want float32 or bfloat16 (R, C) x on a CUDA "
            f"device, scale float32 and add in x's dtype on the same device; "
            f"got x {tuple(shape)} {x.dtype} on {x.device}, scale "
            f"{None if scale is None else (scale.dtype, scale.device)}, add "
            f"{None if add is None else (add.dtype, add.device)}")
    n_groups, C = shape[0] // s, shape[1]
    out = _build.empty((n_groups, C), x.dtype, dev)
    if n_groups * C == 0:
        return out
    if n_groups * C >= 2 ** 31:
        raise ValueError(f"rowgroup_pool: {n_groups} x {C} outputs exceed "
                         f"the kernel's 32-bit indexing")
    if not x.is_contiguous():
        x = x.contiguous()
    flags = _RELU * bool(relu) | _MEAN * bool(mean)
    xp, sp, ap = x.data_ptr(), None, None
    if scale is not None:
        if not scale.is_contiguous():
            scale = scale.contiguous()
        sp = scale.data_ptr()
    if add is not None:
        if not add.is_contiguous():
            add = add.contiguous()
        ap = add.data_ptr()
        if add.shape[0] != 1:
            flags |= _PER_GROUP
    if x.dtype == torch.bfloat16:
        flags |= _BF16
    s_t, vec = pool_plan(s, C, x.element_size(),
                         not (xp | (sp or 0) | (ap or 0)) % 16)
    if vec:
        flags |= _VEC
    err = _build.lib().ogc_rowgroup_pool(xp, sp, ap, n_groups, s, C, s_t,
                                         flags, out.data_ptr(),
                                         _build.raw_stream(dev))
    if err:
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
        sc = None if scale is None else scale.float()
        if add is None:
            ad = None
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
