"""frontier_expand's share of its roofline: the least time of the
window's hops on the chip, from their logical work (work.py: edges out of
the frontier, frontier entries, outputs once), over the device time of
the operations launched inside the program's frontier-expansion call."""
LAYER = "frontier_expand kernel"
UNIT = "%"
MOVES = "fof_seeds_per_s"


def read(r):
    t, bound = r.trace, r.bounds_s.get("frontier_expand")
    if t is None or not bound:
        return None
    spent = t.op_seconds(inside="layer.frontier_expand")
    return 100.0 * bound / spent if spent > 0 else None
