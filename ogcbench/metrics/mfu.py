"""The whole step's share of the card's peak: the model's matmul and
convolution FLOPs a step (``ogcbench/work/``: the forward, and twice it
again for the backward of a train step; recompute not counted), each
product at the peak of the precision it runs in, over the traced window's
seconds."""

from ogcbench.trace import model_work

LAYER = "models (the whole step)"
UNIT = "%"
MOVES = "samples_per_s"


def read(s):
    if not s.dev or not s.products or s.window_s <= 0:
        return None
    return 100.0 * s.steps * model_work(s.products, s.peaks) / s.window_s
