"""Seconds of `build_device_graph`: the PSW compile of the store (host
build and upload), ending in a device synchronize."""
LAYER = "PSW compile"
UNIT = "s"
MOVES = "setup_s"


def read(r):
    return r.setup_spans.get("device_graph")
