"""Fixtures of the benchmark's own tests: a temporary checkout holding
``BENCHMARK.json`` and ``bench_h100/`` whose cells can be cut to a size
the CPU runs in seconds, and a run of one cell there on the CPU (the
harness's look for a card skipped)."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell cut to a CPU's size: the widths stay, the batch and the traffic shrink
TINY = {
    "tpgan-train-b50": {"batch": 2, "steps_per_dispatch": 2, "pack_items": 8,
                        "trace_dispatches": 1},
    "mnv2-pretrain-b64": {"batch": 4, "pool": 8, "checked_steps": 2, "trace_steps": 1},
    "tpgan-serve-b128": {"batch": 2, "pool_batches": 2, "samples": 2, "sample_range": 2,
                         "trace_forwards": 1},
    "tpgan-serve-b8": {"batch": 2, "pool_requests": 2, "samples": 2, "sample_range": 2,
                       "warm_requests": 1, "trace_requests": 1},
}


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark's files, to edit without touching the repo."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_h100", tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def shrink(root: Path, cell: str) -> None:
    path = root / "bench_h100" / "workloads" / f"{cell}.json"
    workload = json.loads(path.read_text())
    workload["traffic"].update(TINY[cell])
    path.write_text(json.dumps(workload))


def run_on_cpu(root: Path, cell: str, seed: int = 2 ** 31 + 12345, trace: bool = False):
    """One run of ``cell`` cut to the CPU's size: its driver and, traced,
    its per-layer readers. Returns (run, per-layer readings)."""
    import torch

    from bench_h100 import harness

    torch.set_num_threads(4)
    shrink(root, cell)
    c = harness.load_cell(cell, root)
    seconds = 1.0 if c.traffic["driver"].startswith("serve") else 0.1
    r = harness.Run(c, seed, seconds, trace, time.perf_counter(), device="cpu")
    driver = harness.load_module(harness.BENCH / "drivers" / f"{c.traffic['driver']}.py",
                                 c.traffic["driver"])
    driver.run(r)
    readings = {}
    if trace:
        for m in c.per_layer():
            reader = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py", m["name"])
            readings[m["name"]] = reader.read(r)
    return r, readings
