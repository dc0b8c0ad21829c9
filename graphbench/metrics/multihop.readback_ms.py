"""Host ms a request inside the program's `x.multihop.readback` spans, read
from their `layer.` annotations in the trace: the `torch.nonzero` calls,
the count gather and the copies to the host of `_two_hop_dense`, where the
request's thread waits for the device to finish the block's hops. Read
only where the window holds one `layer.multihop.two_hop` a request."""
from graphbench.program_spans import host_ms

LAYER = "multi-hop operators"
UNIT = "ms"
MOVES = "fof_seeds_per_s"
SPAN = "layer.x.multihop.readback"


def read(r):
    return host_ms(r, SPAN, "layer.multihop.two_hop")
