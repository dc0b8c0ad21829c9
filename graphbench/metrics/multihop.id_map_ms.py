"""Host ms a request inside the program's `x.multihop.id_map` spans, read
from their `layer.` annotations in the trace: `IntervalMap.to_original`
over the indices `_two_hop_dense` read back, and the packing of their
keys. Read only where the window holds one `layer.multihop.two_hop` a
request."""
from graphbench.program_spans import host_ms

LAYER = "multi-hop operators"
UNIT = "ms"
MOVES = "fof_seeds_per_s"
SPAN = "layer.x.multihop.id_map"


def read(r):
    return host_ms(r, SPAN, "layer.multihop.two_hop")
