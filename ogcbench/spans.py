"""The program's own spans against the device's idle time in a traced
window: what the span readers of ``ogcbench/metrics/`` share.

The program records its spans (``ogc_tpu_torch.utils.trace``) on the
profiler's host clock while the window's profiler runs.  Here the device's
idle intervals are rebuilt from ``Summary.dev``: the time between the first
and the last ``ogcbench.step`` event of ``Summary.cpu`` that no device
event covers.  The spans kept are those that meet that range.  Each span's
own idle time is the idle time inside it less that inside its child
spans, so the spans of one step split the idle time of its outer span
(``train.step``, ``flow.batch``) without overlap: ``sync.*`` spans keep
their own wait, the phase that holds one keeps the rest.

A program without the recorder, or a window with no span of a reader's,
gives None.
"""

from __future__ import annotations

import bisect
from typing import Callable, List, Optional, Tuple

from ogcbench.trace import STEP

SYNC = "sync."


def program_spans() -> List[tuple]:
    """``ogc_tpu_torch.utils.trace.spans()``, or [] where the program has
    no recorder."""
    try:
        from ogc_tpu_torch.utils import trace
    except ImportError:
        return []
    return trace.spans()


def step_range(s) -> Optional[Tuple[int, int]]:
    """From the first ``ogcbench.step`` event's start to the last one's
    end (ns), or None."""
    steps = [(a, b) for name, a, b in s.cpu if name == STEP]
    if not steps:
        return None
    return min(a for a, _ in steps), max(b for _, b in steps)


def idle_intervals(dev, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The parts of [lo, hi] that no device interval covers, in order."""
    out, t = [], lo
    for _, a, b in sorted(dev, key=lambda e: e[1]):
        if b <= t:
            continue
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


class Idle:
    """Idle nanoseconds inside any interval, by bisection over the idle
    intervals' running sum."""

    def __init__(self, intervals: List[Tuple[int, int]]):
        self.starts = [a for a, _ in intervals]
        self.ends = [b for _, b in intervals]
        self.before = [0]
        for a, b in intervals:
            self.before.append(self.before[-1] + b - a)

    def upto(self, t: int) -> int:
        """Idle ns before t."""
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0
        return self.before[i - 1] + min(t, self.ends[i - 1]) - \
            self.starts[i - 1]

    def within(self, a: int, b: int) -> int:
        return self.upto(b) - self.upto(a) if b > a else 0


def own_idle(s, spans: Optional[list] = None
             ) -> Optional[List[Tuple[tuple, int]]]:
    """Each closed span that meets the steps' range, with its own idle ns
    there (inside it, outside its children), in recorded order; None
    without a range."""
    rng = step_range(s)
    if rng is None:
        return None
    lo, hi = rng
    spans = program_spans() if spans is None else spans
    idle = Idle(idle_intervals(s.dev, lo, hi))
    # overlap, not containment: the profiler's host events sit on an
    # approximate clock, microseconds from time.time_ns()
    kept = {i: sp for i, sp in enumerate(spans)
            if sp[2] is not None and sp[1] < hi and lo < sp[2]}
    whole = {i: idle.within(sp[1], sp[2]) for i, sp in kept.items()}
    own = dict(whole)
    for i, sp in kept.items():
        if sp[3] in own:
            own[sp[3]] -= whole[i]
    return [(kept[i], own[i]) for i in sorted(kept)]


def idle_ms(s, pick: Callable[[str], bool]) -> Optional[float]:
    """Own idle ms a step of the spans whose name ``pick`` takes, or None
    where the window holds none."""
    found = [ns for sp, ns in own_idle(s) or () if pick(sp[0])]
    if not found or not s.steps:
        return None
    return sum(found) / 1e6 / s.steps

