"""Device-idle ms a step inside Adam's step (``train.optimizer``: the
Python loop over the parameters on an empty queue), its finite-gradient
guard's wait left out."""

from ogcbench.spans import idle_ms

LAYER = "trainer"
UNIT = "ms"
MOVES = "samples_per_s"


def read(s):
    return idle_ms(s, lambda name: name == "train.optimizer")
