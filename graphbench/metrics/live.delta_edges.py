"""The mean of the `delta_edges` tag of the window's `x.multihop.delta`
spans: the signed entries the live dense plan's delta applies to each hop
of a request, the writes since the base plan was built, reduced to changes
of key presence. Nothing where the program records no such span."""
LAYER = "live dense plan"
UNIT = "edges"
MOVES = "fof_seeds_per_s"


def read(r):
    tags = [e["args"]["delta_edges"] for e in r.program_spans
            if e.get("name") == "x.multihop.delta"
            and "delta_edges" in e.get("args", {})]
    return sum(tags) / len(tags) if tags else None
