"""graph_idle_ms.train: device milliseconds per train step in which no
operation ran while the host was inside the port's ``graph.dispatch`` spans
(``make_multi_step``'s checks, input copies, replays and output copies),
over the traced steps; moves ``train_images_per_s``. None when the trace
holds no such span."""

from bench_h100 import harness

SPAN = "graph.dispatch"


def read(run):
    if run.trace is None or not any(cat == "user_annotation" and name == SPAN
                                    for cat, name, _ts, _dur in run.trace.host):
        return None
    return harness.idle_ms_per_unit(run, SPAN)
