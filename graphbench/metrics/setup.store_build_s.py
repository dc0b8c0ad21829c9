"""Seconds of `GraphPAL.from_edges`, the bulk load of the store: the
benchmark's host-clock span around the call."""
LAYER = "store"
UNIT = "s"
MOVES = "setup_s"


def read(r):
    return r.setup_spans.get("store_build")
