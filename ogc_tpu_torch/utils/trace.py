"""Named host spans of the program, on the profiler's clock.

``span(name)`` brackets a phase of the host's work.  It records only while
a ``torch.profiler`` session runs; otherwise it returns one shared null
context, which takes no timestamp, allocates nothing and touches no
device.  A recorded span is the tuple

    (name, start_ns, end_ns, parent, step, thread)

with ``time.time_ns()`` timestamps (CLOCK_REALTIME, the clock the
profiler's events are stamped on), ``parent`` the index in ``spans()`` of
the span that encloses it on the same thread (None at the top), ``step``
the id that the enclosing step span opened (None outside any) and
``thread`` the thread's ident.  A step span (``step=True``: ``train.step``,
``flow.batch``) opens a new id.

Names are ``<layer>.<phase>``; each host wait on the device is a span
``sync.<site>`` of its own, so a sync's count and wait sit where it
happens.  A span records no device event: a ``record_function`` range
would show on the device's timeline, as device work.

``spans()`` returns what was recorded, ``clear()`` forgets it; a reader
calls them after a profiled run.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import nullcontext
from typing import List, Optional, Tuple

from torch.autograd import profiler as _profiler

Span = Tuple[str, int, Optional[int], Optional[int], Optional[int], int]

_NULL = nullcontext()
_LOCK = threading.Lock()
_SPANS: List[Span] = []
_STEPS = itertools.count()
_LOCAL = threading.local()


class _Open:
    """One recorded span, from entry to exit."""

    __slots__ = ("name", "opens_step", "list", "index")

    def __init__(self, name: str, opens_step: bool):
        self.name, self.opens_step = name, opens_step

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        parent = step = None
        if stack:
            # a parent recorded before the last clear() is no longer listed
            outer, parent, step = stack[-1]
            parent = parent if outer is _SPANS else None
        if self.opens_step:
            step = next(_STEPS)
        thread = threading.get_ident()
        with _LOCK:
            self.list, self.index = _SPANS, len(_SPANS)
            _SPANS.append((self.name, time.time_ns(), None, parent, step,
                           thread))
        stack.append((self.list, self.index, step))
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _LOCAL.stack.pop()
        name, start, _, parent, step, thread = self.list[self.index]
        self.list[self.index] = (name, start, end, parent, step, thread)
        return False


def span(name: str, step: bool = False):
    """A context manager recording ``name`` while the profiler runs;
    ``step=True`` opens a new step id for the spans inside it."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name, step)


def spans() -> List[Span]:
    """The spans recorded since the last ``clear()``, in the order they
    opened; one still open has ``end_ns`` None."""
    return list(_SPANS)


def clear() -> None:
    """Forget the recorded spans (the step ids go on counting)."""
    global _SPANS
    with _LOCK:
        _SPANS = []
