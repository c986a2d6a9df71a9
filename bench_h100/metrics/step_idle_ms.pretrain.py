"""step_idle_ms.pretrain: device milliseconds per step in which no operation
ran while the host was inside one of the port's five detector-step spans
(``pretrain.forward``, ``.loss``, ``.backward``, ``.optimizer``,
``.metrics``: disjoint, in turn), over the traced steps; moves
``pretrain_images_per_s``. It follows the traced host's speed, which
differs between processes: compare it over several traced runs. None
unless the trace holds all five."""

from bench_h100 import harness

SPANS = ("pretrain.forward", "pretrain.loss", "pretrain.backward", "pretrain.optimizer",
         "pretrain.metrics")


def read(run):
    if run.trace is None:
        return None
    seen = {name for cat, name, _ts, _dur in run.trace.host if cat == "user_annotation"}
    if not set(SPANS) <= seen:
        return None
    parts = [harness.idle_ms_per_unit(run, name) for name in SPANS]
    return None if None in parts else sum(parts)
