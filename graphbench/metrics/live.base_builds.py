"""The live dense plan's base builds in the window: the program's counter
`x.multihop.base_builds` at the window's end less at its start. A build
takes seconds at this size; none is expected in a window. Nothing where
the program has no such counter."""
LAYER = "live dense plan"
UNIT = "builds"
MOVES = "fof_seeds_per_s"


def read(r):
    return r.counters.get("x.multihop.base_builds")
