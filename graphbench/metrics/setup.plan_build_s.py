"""Seconds of `dense_plan`: the store's deduplicated edge set laid out for
frontier_expand (`build_frontier_plan` on the host, `plan_to_device`),
ending in a device synchronize."""
LAYER = "dense plan"
UNIT = "s"
MOVES = "setup_s"


def read(r):
    return r.setup_spans.get("plan_build")
