"""sample_idle_ms.pretrain: device milliseconds per step in which no
operation ran while the host was inside the port's ``data.sample`` spans
(``device_bucketed_batch_iterator`` drawing and gathering a batch), over
the traced steps: ``input_wait_ms.pretrain`` timed from inside the
program; moves ``pretrain_images_per_s``. None when the trace holds no
such span."""

from bench_h100 import harness

SPAN = "data.sample"


def read(run):
    if run.trace is None or not any(cat == "user_annotation" and name == SPAN
                                    for cat, name, _ts, _dur in run.trace.host):
        return None
    return harness.idle_ms_per_unit(run, SPAN)
