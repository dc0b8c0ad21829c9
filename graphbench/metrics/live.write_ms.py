"""Host ms a request inside the benchmark's own `graphbench.writes`
annotation: the request's link writes on the `ServiceDB` (one grouped
insert, the column updates, the deletes), each acknowledged after its WAL
record reaches the OS. Read only where the window holds one
`layer.multihop.two_hop` a request."""
from graphbench.program_spans import host_ms

LAYER = "write path"
UNIT = "ms"
MOVES = "fof_seeds_per_s"
SPAN = "graphbench.writes"


def read(r):
    return host_ms(r, SPAN, "layer.multihop.two_hop")
