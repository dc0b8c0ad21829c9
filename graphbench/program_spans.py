"""What the per-layer metrics on the program's own spans read: a span's
`layer.` annotation in the window's trace, per unit of work (a request or a
job, counted by the annotation of the program's span around each unit).

Both return None where there is no trace, or where the window does not
hold one unit span for each unit of `r`: a program without the spans (the
parent of the PR that added them) reads nothing rather than a wrong
number."""


def _in_window(r, unit_span):
    """The annotations that start in the traced window, or None unless
    `unit_span` opens there once for each of `r.units`."""
    t = r.trace
    if t is None or t.window is None or not r.units:
        return None
    lo, hi = t.window.start, t.window.end
    spans = [s for s in t.spans if lo <= s.start < hi]
    if sum(s.name == unit_span for s in spans) != r.units:
        return None
    return spans


def host_ms(r, span, unit_span):
    """Host ms a unit inside the annotations named `span`."""
    spans = _in_window(r, unit_span)
    mine = [s.dur for s in spans or () if s.name == span]
    return sum(mine) / 1e3 / r.units if mine else None


def device_ms(r, span, unit_span):
    """Device ms a unit of the operations launched inside `span`."""
    if _in_window(r, unit_span) is None or not r.trace.has_span(span):
        return None
    return r.trace.op_seconds(inside=span) * 1e3 / r.units
