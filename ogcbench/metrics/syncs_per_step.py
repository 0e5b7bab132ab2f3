"""The program's host waits on the device a step: its ``sync.*`` spans in
the traced window over the window's steps."""

from ogcbench.spans import SYNC, own_idle

LAYER = "trainer"
UNIT = "syncs/step"
MOVES = "samples_per_s"


def read(s):
    found = [sp for sp, _ in own_idle(s) or () if sp[0].startswith(SYNC)]
    if not found or not s.steps:
        return None
    return len(found) / s.steps
