"""Work counting shared by the function files: the bytes of a tensor and
the (query, point) pairs a spatially pruned search must test on the run's
data."""

from __future__ import annotations

import torch

#: f32 operations of a pair's direct-form d2: 3 subtractions, 3 products,
#: 2 sums (the compare is not a floating-point operation).
D2_OPS = 8
#: queries a cloud sampled for the pair count, which is scaled up to all
SAMPLE = 256


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


@torch.no_grad()
def box_pairs(q: torch.Tensor, p: torch.Tensor, half: torch.Tensor,
              last: torch.Tensor = None) -> float:
    """Pairs a search pruned by spatial cells must test: per query, the
    points inside the cube of half-width ``half`` (B, N) around it, and
    with ``last`` (B, N) only those of index <= last (a ball full by then
    needs no later point).  Counted on every ``N / SAMPLE``-th query and
    scaled to all N."""
    B, N, _ = q.shape
    sel = torch.arange(0, N, max(1, N // SAMPLE), device=q.device)
    qs, hs = q[:, sel].float(), half[:, sel].float()
    idx = torch.arange(p.shape[1], device=q.device)
    total = 0
    for b in range(B):
        inside = ((p[b].float()[None] - qs[b][:, None]).abs().amax(-1)
                  <= hs[b][:, None])
        if last is not None:
            inside &= idx[None] <= last[b, sel][:, None]
        total += int(inside.sum())
    return total * N / len(sel)
