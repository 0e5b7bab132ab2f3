"""Device-idle ms a step inside the unsupervised flow loss (``loss.flow``:
each iteration's Chamfer and smoothness terms and their neighbour
searches), its ``sync.*`` waits left out."""

from ogcbench.spans import idle_ms

LAYER = "loss"
UNIT = "ms"
MOVES = "samples_per_s"


def read(s):
    return idle_ms(s, lambda name: name == "loss.flow")
