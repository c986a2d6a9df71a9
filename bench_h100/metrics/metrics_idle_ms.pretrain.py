"""metrics_idle_ms.pretrain: device milliseconds per step in which no operation
ran while the host was inside the port's ``pretrain.metrics`` spans (decode,
accuracy and the metrics' all-reduce), over the traced steps: one phase of
``step_idle_ms.pretrain``; moves ``pretrain_images_per_s``. It follows the
traced host's speed, which differs between processes: compare it over
several traced runs. None when the trace holds no such span."""

from bench_h100 import harness

SPAN = "pretrain.metrics"


def read(run):
    if run.trace is None or not any(cat == "user_annotation" and name == SPAN
                                    for cat, name, _ts, _dur in run.trace.host):
        return None
    return harness.idle_ms_per_unit(run, SPAN)
