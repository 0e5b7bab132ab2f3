"""Device-idle ms a step inside the loss's host matching (``loss.match``:
the argmax readbacks' aftermath, the one-hot IoU matrices and the host
assignment solver), its ``sync.*`` waits left out."""

from ogcbench.spans import idle_ms

LAYER = "loss"
UNIT = "ms"
MOVES = "samples_per_s"


def read(s):
    return idle_ms(s, lambda name: name == "loss.match")
