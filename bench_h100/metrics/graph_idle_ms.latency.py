"""graph_idle_ms.latency: device milliseconds per request in which no
operation ran while the host was inside the port's ``graph.dispatch`` spans
(the graphed synthesis's input copies, replay and output copy), over the
traced requests; the rest of a request's idle time is the client's copy
back and sync; moves ``serve_p95_ms``. None when the trace holds no such
span."""

from bench_h100 import harness

SPAN = "graph.dispatch"


def read(run):
    if run.trace is None or not any(cat == "user_annotation" and name == SPAN
                                    for cat, name, _ts, _dur in run.trace.host):
        return None
    return harness.idle_ms_per_unit(run, SPAN)
