"""Host ms a request inside the program's `x.multihop.delta` span, read from
its `layer.` annotation in the trace: the live dense plan's delta for the
request's view (the mutation log folded up to the view, reduced to changes
of key presence, the new entries uploaded). Read only where the window
holds one `layer.multihop.two_hop` a request; nothing where the program
has no such span."""
from graphbench.program_spans import host_ms

LAYER = "live dense plan"
UNIT = "ms"
MOVES = "fof_seeds_per_s"
SPAN = "layer.x.multihop.delta"


def read(r):
    return host_ms(r, SPAN, "layer.multihop.two_hop")
