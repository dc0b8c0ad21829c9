"""Host ms a request inside the program's `x.multihop.assemble` span, read
from its `layer.` annotation in the trace: what `_two_hop_dense` does
after its last seed block (the concatenations, the friend-key sort, both
semijoins, the argsort and the offsets). Read only where the window holds
one `layer.multihop.two_hop` a request."""
from graphbench.program_spans import host_ms

LAYER = "multi-hop operators"
UNIT = "ms"
MOVES = "fof_seeds_per_s"
SPAN = "layer.x.multihop.assemble"


def read(r):
    return host_ms(r, SPAN, "layer.multihop.two_hop")
