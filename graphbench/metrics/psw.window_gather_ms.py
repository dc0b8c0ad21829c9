"""Device ms a job of the operations launched inside the program's
`x.psw.window_gather` spans (their `layer.` annotations in the trace): each
sweep's window exchange, the index build and the edge gather. Read only
where the window holds one `layer.x.psw.pagerank` a job."""
from graphbench.program_spans import device_ms

LAYER = "PSW sweep"
UNIT = "ms"
MOVES = "pagerank_job_ms"
SPAN = "layer.x.psw.window_gather"


def read(r):
    return device_ms(r, SPAN, "layer.x.psw.pagerank")
