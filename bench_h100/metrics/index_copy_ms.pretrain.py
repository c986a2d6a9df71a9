"""index_copy_ms.pretrain: host milliseconds per step inside the port's
``data.index_copy`` spans (the sampler's index vector copied to the card
from pageable memory, which waits for the stream to drain), the spans'
durations clipped to the traced segment, over the traced steps; moves
``pretrain_images_per_s``. It follows the traced host's speed, which
differs between processes: compare it over several traced runs. None when
the trace holds no such span."""

SPAN = "data.index_copy"


def read(run):
    units = run.counts.get("traced_units")
    if run.trace is None or not units:
        return None
    t = run.trace
    spans = [(max(ts, t.start_us), min(ts + dur, t.end_us))
             for cat, name, ts, dur in t.host if cat == "user_annotation" and name == SPAN]
    if not spans:
        return None
    return sum(max(b - a, 0.0) for a, b in spans) / 1e3 / units
