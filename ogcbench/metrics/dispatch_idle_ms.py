"""Device-idle ms a step inside the step's outer span (``train.step``,
``flow.batch``) and inside none of its child spans: the host's own Python
and eager dispatch falling behind the device."""

from ogcbench.spans import idle_ms

LAYER = "ops (host dispatch)"
UNIT = "ms"
MOVES = "samples_per_s"


def read(s):
    return idle_ms(s, lambda name: name in ("train.step", "flow.batch"))
