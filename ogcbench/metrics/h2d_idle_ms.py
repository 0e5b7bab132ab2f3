"""Device-idle ms a step inside the host-to-device copy of the step's
inputs (``train.h2d``, ``flow.h2d``), its ``sync.*`` waits left out."""

from ogcbench.spans import idle_ms

LAYER = "entry"
UNIT = "ms"
MOVES = "samples_per_s"


def read(s):
    return idle_ms(s, lambda name: name.endswith(".h2d"))
