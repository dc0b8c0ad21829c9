"""Device ms a request of every operation that is not frontier_expand's:
the multi-hop operators' indicator scatter, binarize, `nonzero` and
read-backs. Needs the trace's `layer.frontier_expand` annotations to tell
the two apart."""
LAYER = "multi-hop operators"
UNIT = "ms"
MOVES = "fof_seeds_per_s"


def read(r):
    t = r.trace
    if t is None or not r.units or not t.has_span("layer.frontier_expand"):
        return None
    s = t.op_seconds(inside="graphbench.request",
                     outside="layer.frontier_expand")
    return s * 1e3 / r.units
