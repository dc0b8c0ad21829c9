"""Device ms a job of the operations launched inside the program's
`x.psw.segment_sum` spans (their `layer.` annotations in the trace): each
sweep's `segment_sum_sorted`, the float64 cast, the pad, both scans, the
gather at the bounds and the cast back. Read only where the window holds
one `layer.x.psw.pagerank` a job."""
from graphbench.program_spans import device_ms

LAYER = "PSW sweep"
UNIT = "ms"
MOVES = "pagerank_job_ms"
SPAN = "layer.x.psw.segment_sum"


def read(r):
    return device_ms(r, SPAN, "layer.x.psw.pagerank")
