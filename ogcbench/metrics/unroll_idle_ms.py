"""Device-idle ms a step inside FlowStep3D's forward over the unrolled
refinement in training (``flow.unroll``: the encoders, the correlations
and the GRU iterations dispatched op by op), its ``sync.*`` waits left
out."""

from ogcbench.spans import idle_ms

LAYER = "models (the whole step)"
UNIT = "ms"
MOVES = "samples_per_s"


def read(s):
    return idle_ms(s, lambda name: name == "flow.unroll")
