"""One run of one cell of the port's benchmark on an NVIDIA GPU:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench_h100/``
and the port, ``tpgan_tpu_torch/``. The cell's files are found by its
name: ``bench_h100/workloads/<cell>.json`` (its configuration, traffic and
limits), the configuration's file under ``bench_h100/configs/``, the
driver ``bench_h100/drivers/<traffic driver>.py`` and, with ``--trace 1``,
each per-layer metric's reader ``bench_h100/metrics/<metric>.py``.

A run sets the cell up from ``--seed`` (weights, data and draws made on the
card), measures for ``--seconds``, with ``--trace 1`` also profiles a
short segment after the window, compares what the timed path produced
with the plain reference under ``bench_h100/reference/``, and prints the
numbers compared with their limits on standard error and, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, traced, ``breakdown``; then
``readings`` and ``checks``.

Exit codes: 0 with a result (``correct`` may be false); 3 without a CUDA
device or with fewer than the cell asks for; 4 when JAX or the JAX
package was loaded; anything else is a failure with no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache the run may fill, at fixed paths in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / "build" / "bench_h100" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / "build" / "bench_h100" / "triton"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    from bench_h100 import harness

    cell = harness.load_cell(args.workload, ROOT)
    import torch

    torch.set_num_threads(4)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_h100: cell {cell.name} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace), T0)
    driver = harness.load_module(harness.BENCH / "drivers" / f"{cell.traffic['driver']}.py",
                                 cell.traffic["driver"])
    driver.run(run)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": run.memory_peak_bytes, "power_limit_w": harness.power_limit_w()}
    breakdown = None
    if args.trace:
        metrics = {}
        for m in cell.per_layer():
            reader = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py", m["name"])
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if run.trace is not None:
            device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
            breakdown = {"device_ops": run.trace.top_ops(10), "idle_gaps": run.trace.idle_gaps(10)}
    else:
        metrics = {m["name"]: {"value": float(run.e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end()}

    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"bench_h100: the run's process loaded {loaded}; no result", file=sys.stderr)
        return 4
    line = harness.result_line(run, metrics, device, breakdown)
    print(f"correct {line['correct']}", file=sys.stderr)
    for name, (value, limit) in run.checks.items():
        print(f"check {name} {value:.6g} limit {limit:.6g}", file=sys.stderr)
    sys.stderr.flush()
    import json

    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
