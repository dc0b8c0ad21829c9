"""Host ms a request of the multi-hop operators: the program's
`multihop.two_hop` span a request, less the device's busy time inside the
request (id mapping, semijoin, sort, and launches)."""
LAYER = "multi-hop operators"
UNIT = "ms"
MOVES = "fof_seeds_per_s"


def read(r):
    t = r.trace
    spans = [e["dur"] for e in r.program_spans
             if e.get("name") == "multihop.two_hop"]
    if t is None or not spans or len(spans) != r.units:
        return None
    busy = t.busy_within(t.spans_named("graphbench.request"))
    return (sum(spans) / 1e3 - busy * 1e3) / r.units
