"""The port's hand-written kernels against their roofline: the sum of the
least times of the calls recorded in the traced window (the larger of
bytes over the HBM rate and operations over the peak, for the work the
function needs on the run's data, ``ogcbench/work/``) over the sum of the
device times of the kernels that implement those functions."""

LAYER = "kernels"
UNIT = "%"
MOVES = "samples_per_s"


def read(s):
    called = {name for name, _ in s.least}
    prefixes = tuple(p for name in called for p in s.kernels[name])
    device = s.device_seconds(prefixes) if prefixes else 0.0
    if device <= 0:
        return None
    return 100.0 * sum(t for _, t in s.least) / device
