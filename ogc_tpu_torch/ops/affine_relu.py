"""FlowStep3D's eval norm + ReLU in one pass: the CUDA kernel
(csrc/affine_relu.cu) and its plain PyTorch version.

Replaces no TPU kernel (XLA fuses these into the product's epilogue on the
TPU); it replaces two eager chains of nn/flowstep3d.py's eval conv stacks,
each a pass over the whole (B, M, S, C) tensor per operation:

    channel:  y = relu((((x - m) * r) * w) + b)   m, r, w, b (C,)
    rows:     y = relu(x + t[:, :, None, :])       x (B, M, S, C), t (B, M, C)

the first ``F.relu(SchedulableBatchNorm(x))`` in eval (``m`` the running
mean, ``r`` = rsqrt(running var + eps), ``w`` and ``b`` the affine, each in
x's dtype: ``SchedulableBatchNorm.eval_operands``), the second the
source-projected first layer's centre term and ReLU.  The plain version is
those chains as the model ran them; the kernel is bit-equal to them on the
card in float32 and bfloat16 (csrc/affine_relu.cu).

``affine_relu`` routes by the tensor's device: a CPU tensor takes
``affine_relu_plain`` (a new tensor, whatever ``inplace`` says); a CUDA
tensor launches the kernel or raises.  ``affine_relu.launches`` counts
kernel launches.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ogc_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
# Bits of the C entry's flags argument (csrc/affine_relu.cu).
_BF16, _ROWS, _VEC = 1, 2, 4


def _check_args(x, channel, rows) -> None:
    """Shapes and dtypes, on any device: exactly one form, its operands in
    x's dtype."""
    if (channel is None) == (rows is None):
        raise ValueError("affine_relu: give channel=(m, r, w, b) or rows=t")
    if channel is not None:
        if x.dim() < 1 or len(channel) != 4:
            raise ValueError(f"affine_relu: x {tuple(x.shape)} with "
                             f"{len(channel)} channel operands, want (..., "
                             f"C) and (m, r, w, b)")
        ops = tuple(channel)
        want = x.shape[-1:]
    else:
        if x.dim() != 4:
            raise ValueError(f"affine_relu: x {tuple(x.shape)}, want (B, M, "
                             f"S, C) with rows=t")
        ops = (rows,)
        want = x.shape[:2] + x.shape[3:]
    for op in ops:
        if op.shape != want:
            raise ValueError(f"affine_relu: operand {tuple(op.shape)}, want "
                             f"{tuple(want)} for x {tuple(x.shape)}")
        if op.dtype != x.dtype:
            raise ValueError(f"affine_relu: operand {op.dtype}, want x's "
                             f"{x.dtype}")


def affine_relu_plain(x: torch.Tensor,
                      channel: Optional[Sequence[torch.Tensor]] = None,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The eager chains: ``relu((x - m) * r * w + b)`` or ``relu(x + t[:,
    :, None, :])``, one torch operation at a time in x's dtype (each result
    rounded to it).  :return: a new tensor of x's shape and dtype."""
    _check_args(x, channel, rows)
    if channel is not None:
        m, r, w, b = channel
        return torch.relu((x - m) * r * w + b)
    return torch.relu(x + rows[:, :, None, :])


def affine_relu(x: torch.Tensor,
                channel: Optional[Sequence[torch.Tensor]] = None,
                rows: Optional[torch.Tensor] = None,
                inplace: bool = False) -> torch.Tensor:
    """``affine_relu_plain``'s function of a float32 or bfloat16 x, with
    ``channel`` (m, r, w, b), each (C,), or ``rows`` t (B, M, C) for x (B,
    M, S, C), every operand in x's dtype.  ``inplace``: on the card the
    result overwrites x (the caller gives up x; no gradient may need it)."""
    if x.is_cpu:
        return affine_relu_plain(x, channel, rows)
    _check_args(x, channel, rows)
    ops = tuple(channel) if channel is not None else (rows,)
    if x.dtype not in _DTYPES:
        raise ValueError(f"affine_relu: x dtype {x.dtype}, want float32 or "
                         f"bfloat16")
    if not (x.is_contiguous() and all(op.is_contiguous() for op in ops)):
        raise ValueError("affine_relu: x and its operands must be "
                         "contiguous")
    dev = x.get_device()
    if dev < 0 or any(op.get_device() != dev for op in ops):
        raise ValueError(f"affine_relu: x and its operands on one CUDA "
                         f"device, got x on {x.device}, operands on "
                         f"{[str(op.device) for op in ops]}")
    C = x.shape[-1]
    n_rows = x.numel() // C if C else 0
    if n_rows == 0:
        return x if inplace else torch.empty_like(x)
    if n_rows >= 2 ** 31:
        raise ValueError(f"affine_relu: {n_rows} rows exceed the kernel's "
                         f"32-bit row index")
    out = x if inplace else _build.empty(x.shape, x.dtype, dev)
    xp, outp = x.data_ptr(), out.data_ptr()
    if channel is not None:
        m, r, w, b = (t.data_ptr() for t in channel)
        tp, s, flags = None, 1, 0
    else:
        m = r = w = b = None
        tp, s, flags = rows.data_ptr(), x.shape[2], _ROWS
    if x.dtype == torch.bfloat16:
        flags |= _BF16
    if (C * x.element_size()) % 16 == 0 and not (xp | outp | (tp or 0)) % 16:
        flags |= _VEC
    err = _build.lib().ogc_affine_relu(xp, m, r, w, b, tp, n_rows, s, C,
                                       flags, outp, _build.raw_stream(dev))
    if err:
        _build.check(err, "ogc_affine_relu")
    affine_relu.launches += 1
    return out


affine_relu.launches = 0
