"""Device-side events (kernels, copies, sets) a step in the traced window:
what the host has to enqueue for each step."""

LAYER = "ops (host dispatch)"
UNIT = "launches/step"
MOVES = "samples_per_s"


def read(s):
    if not s.dev or not s.steps:
        return None
    return len(s.dev) / s.steps
