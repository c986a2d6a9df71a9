"""request_ms_p50.latency: the median latency of all requests in the
window, send to output on the host; moves ``serve_p95_ms``."""


def read(run):
    return run.counts.get("request_ms_p50")
