"""The 95th percentile of the latencies of the window's requests, send to
answer, on the host clock: what `fof_p95_ms` reads, kept per layer in a
cell whose runs spread too widely between processes for that metric's
bound."""
import numpy as np

LAYER = "multi-hop operators"
UNIT = "ms"
MOVES = "fof_seeds_per_s"


def read(r):
    if not r.latencies_ms:
        return None
    return float(np.percentile(r.latencies_ms, 95))
