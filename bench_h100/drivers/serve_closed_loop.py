"""Driver ``serve_closed_loop``: a service frontalizing the faces of one
request at a time, one client, closed loop.

Set-up makes the generator's weights on the card from the seed, builds the
port's graphed synthesis (``make_graphed_synthesize_fn``) and a pool of
``pool_requests`` distinct requests in pinned host memory, each ``batch``
seeded crop sets (float32 NHWC) and their noise; the first request
captures the graph. In the window the client sends request after
request: each is copied to the card, synthesized as one graph replay and
copied back into pinned host memory, and its latency runs from the send
to the host holding the output.

``correct``: ``samples`` requests drawn from the seed among the
window's first ``sample_range`` keep their output; the plain reference
computes each from the same inputs in float32, and the worst image's
relative L2 gap is compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100 import harness, port
from bench_h100.counts import flops
from bench_h100.drivers.serve_throughput import Judge, build, crop_sets



def run(r: harness.Run) -> None:
    conf, tr = r.cell.config, r.cell.traffic
    dev = r.device
    b, n_pool = int(tr["batch"]), int(tr["pool_requests"])
    synth, host = build(r, b)
    pinned = (lambda t: t.pin_memory()) if dev.type == "cuda" else (lambda t: t)
    pool = {k: pinned(v.reshape(n_pool, b, *v.shape[1:]).cpu())
            for k, v in crop_sets(n_pool * b, harness.sub_seed(r.seed, 10), dev).items()}
    zs = pinned(torch.randn((n_pool, b, conf["G"]["zdim"]), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(
                                harness.sub_seed(r.seed, 2))).cpu())
    host_out = pinned(torch.empty((b, 128, 128, 3),
                                  dtype=port.compute_dtype(r.cell.config)))
    latencies = []
    rng = np.random.RandomState(harness.sub_seed(r.seed, 3))
    sampled = set(int(i) for i in rng.choice(int(tr["sample_range"]), int(tr["samples"]),
                                                    replace=False))
    kept = []
    at = {"i": 0}

    def request(record: bool = True):
        i = at["i"]
        q = i % n_pool
        t0 = time.perf_counter()
        with r.span("request"):
            out = synth({k: v[q] for k, v in pool.items()}, zs[q])
            host_out.copy_(out, non_blocking=True)
            r.sync()
        if record:
            latencies.append(time.perf_counter() - t0)
            if i in sampled:
                kept.append(({k: v[q].clone() for k, v in pool.items()}, zs[q].clone(),
                             host_out.clone()))
            at["i"] = i + 1

    for _ in range(int(tr["warm_requests"])):  # the first captures the graph
        request(record=False)
    r.spans.clear()
    r.setup_done()

    start = time.perf_counter()
    while time.perf_counter() - start < r.seconds:
        request()
    lat_ms = np.asarray(latencies) * 1e3
    r.e2e["serve_p95_ms"] = float(np.percentile(lat_ms, 95))
    r.counts["request_ms_p50"] = float(np.percentile(lat_ms, 50))
    r.attempted, r.failed = len(latencies), 0
    r.window_closed()
    if r.trace_on:
        units = int(tr["trace_requests"])
        r.trace = harness.traced(r, lambda: request(record=False), units)
        r.counts.update(traced_units=units)
    r.counts.update(flops_per_image=flops.synthesis_per_image(),
                    peak_flops=float(conf["peak_flops"]))

    del synth, pool
    r.free()
    judge = Judge(conf, host, kept, dev, harness.sub_seed(r.seed, 9))
    harness.judge(r, judge.gaps())
    r.judge = judge
