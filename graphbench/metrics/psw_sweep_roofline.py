"""The PSW sweep's share of its roofline: the least time of the window's
PageRank iterations on the chip, from their logical bytes (work.py: both
endpoints of every edge, the ranks read and the sums written, once), over
the device time of every operation of the window's jobs."""
LAYER = "PSW sweep"
UNIT = "%"
MOVES = "pagerank_job_ms"


def read(r):
    t, bound = r.trace, r.bounds_s.get("psw_sweep")
    if t is None or not bound:
        return None
    spent = t.op_seconds(inside="graphbench.job")
    return 100.0 * bound / spent if spent > 0 else None
