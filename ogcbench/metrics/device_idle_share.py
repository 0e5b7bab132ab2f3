"""Share of the traced window in which no device event runs: 100% minus
the union of the device events' intervals over the window."""

LAYER = "device"
UNIT = "%"
MOVES = "samples_per_s"


def read(s):
    if not s.dev or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
