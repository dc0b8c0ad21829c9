"""The device's idle share of the traced window: 1 - (the union of its
operations' time / the window's length)."""
LAYER = "device"
UNIT = "%"
MOVES = "fof_seeds_per_s"


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
