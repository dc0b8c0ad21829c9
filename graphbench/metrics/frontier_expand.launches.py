"""frontier_expand kernel launches a request: the program's exact count
(`kernels/frontier_expand/ops.launches`) over the window."""
LAYER = "frontier_expand kernel"
UNIT = "launches"
MOVES = "fof_seeds_per_s"


def read(r):
    n = r.counters.get("frontier_expand.launches")
    return None if not n else r.per_unit(n)
