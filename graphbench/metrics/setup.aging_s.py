"""Seconds of the live cell's aging: the link writes that set-up sends
before the window, on the `ServiceDB` in the request's proportions (the
benchmark's host-clock span around them). Where the store is a bulk
`GraphPAL` there is no aging, and nothing is read."""
LAYER = "write path"
UNIT = "s"
MOVES = "setup_s"


def read(r):
    return r.setup_spans.get("aging")
