"""What every cell's run shares: finding a cell's files by name, the
measured window, spans, the profiler trace and its reduction, the
comparison helpers, and the result line.

Nothing here imports the program (``tpgan_tpu_torch``); the drivers do.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# whole top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpgan_tpu")
# units of work the window lets the host queue ahead of the device
INFLIGHT = 2


def sub_seed(seed: int, tag: int) -> int:
    """A seed of its own for each use of the run's ``--seed`` (weights,
    data, draws), below 2**31 so that numpy takes it too."""
    return (int(seed) * 1_000_003 + 7919 * int(tag)) % (2 ** 31 - 1)


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file, whose name may hold
    dots (``metrics/mfu.train.py``)."""
    spec = importlib.util.spec_from_file_location(f"bench_h100_dyn.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict[str, Any]  # its entry under ``workloads`` in BENCHMARK.json
    workload: Dict[str, Any]  # workloads/<name>.json
    config: Dict[str, Any]  # configs/<config>.json
    benchmark: Dict[str, Any]

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.workload["traffic"]

    def end_to_end(self) -> List[Dict[str, Any]]:
        return [m for m in self.benchmark["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[Dict[str, Any]]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.benchmark["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its workload file and its
    configuration file. Raises when any is missing or they disagree."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = json.loads((root / "bench_h100" / "workloads" / f"{name}.json").read_text())
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    if workload["config"] != entry["config"] or workload["traffic"]["name"] != entry["traffic"]:
        raise SystemExit(f"workloads/{name}.json names {workload['config']} x "
                         f"{workload['traffic']['name']}, BENCHMARK.json {entry['config']} x "
                         f"{entry['traffic']}")
    return Cell(name, entry, workload, config, bench)


def forbidden_loaded() -> List[str]:
    """Whole top-level names of ``FORBIDDEN_MODULES`` in ``sys.modules``."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Run:
    """One run of one cell: its arguments, what it measured, what it
    compared, and the spans and counts the per-layer readers take."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
                 device: str = "cuda"):
        import torch

        self.cell, self.seed, self.seconds, self.trace_on, self.t0 = cell, seed, seconds, trace, t0
        # the card; the harness's own tests drive a run on the CPU
        self.device = torch.device(device)
        self.e2e: Dict[str, float] = {}
        self.checks: Dict[str, Tuple[float, float]] = {}
        self.info: Dict[str, Any] = {}
        self.spans: Dict[str, List[float]] = collections.defaultdict(list)
        self.counts: Dict[str, Any] = {}
        self.attempted = 0
        self.failed = 0
        self.trace: Optional["Trace"] = None
        self.memory_peak_bytes: Optional[int] = None
        # the driver's judge, its program readings and the reference's, which
        # calibrate.py reads the controls and faults against
        self.judge = self.judge_prog = self.judge_ref = None

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        self.sync()
        self.e2e["setup_s"] = time.perf_counter() - self.t0

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Host time of the block, kept under ``name``; in a traced
        segment the block is also an annotation of the trace."""
        import torch

        start = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.spans[name].append(time.perf_counter() - start)

    def reset_memory_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def window_closed(self) -> None:
        """Reads the device's peak memory (set-up and window)."""
        import torch

        self.sync()
        self.memory_peak_bytes = (int(torch.cuda.max_memory_allocated(self.device))
                                  if self.device.type == "cuda" else 0)
        self.e2e["peak_device_gib"] = self.memory_peak_bytes / 2 ** 30

    def free(self) -> None:
        """Returns the program's freed device memory before the reference runs."""
        import gc

        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared for ``correct``: it must be finite and at most
        ``limit``."""
        self.checks[name] = (float(value), float(limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(math.isfinite(v) and v <= lim
                                         for v, lim in self.checks.values())


def window(run: Run, dispatch: Callable[[], None]) -> Tuple[int, float]:
    """Calls ``dispatch`` (which enqueues one unit of work on the card) until
    the run's ``seconds`` have passed on the host clock, with at most
    ``INFLIGHT`` units queued ahead of the device, then waits for the
    device. Returns (calls, seconds from the first call to the end of the
    last unit's work)."""
    import torch

    cuda = run.device.type == "cuda"
    events: collections.deque = collections.deque()
    run.sync()
    start = time.perf_counter()
    stamps = [start]
    calls = 0
    while True:
        dispatch()
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
        calls += 1
        while len(events) > INFLIGHT:
            events.popleft().synchronize()
        stamps.append(time.perf_counter())
        if stamps[-1] - start >= run.seconds:
            break
    run.sync()
    elapsed = time.perf_counter() - start
    gaps = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    run.info["window_calls"] = calls
    if len(gaps) > 1:
        run.info["call_ms_quartiles"] = statistics.quantiles(gaps, n=4)
    return calls, elapsed


# --------------------------------------------------------------------------
# the profiler's trace
# --------------------------------------------------------------------------

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
WINDOW_ANNOTATION = "bench_traced_window"


@dataclasses.dataclass
class Trace:
    """A traced segment reduced to what the readers need: the segment's
    length, the device's activity in it, and the host's events."""

    window_s: float
    start_us: float
    end_us: float
    device: List[Tuple[str, float, float]]  # (name, ts_us, dur_us), sorted by ts
    host: List[Tuple[str, str, float, float]]  # (cat, name, ts_us, dur_us)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _name, ts, dur in self.device:
            a, b = max(ts, self.start_us), min(ts + dur, self.end_us)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_time_s(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name matches."""
        rx = re.compile(pattern)
        hits = [dur for name, ts, dur in self.device
                if rx.search(name) and self.start_us <= ts < self.end_us]
        return sum(hits) / 1e6, len(hits)

    def idle_s_under(self, annotation: str) -> float:
        """Seconds of the segment in which no device operation ran while the
        host was inside a span named ``annotation``."""
        spans = sorted((max(ts, self.start_us), min(ts + dur, self.end_us))
                       for cat, name, ts, dur in self.host
                       if cat == "user_annotation" and name == annotation)
        busy = self.busy_intervals()
        idle, i = 0.0, 0
        for a, b in spans:
            covered = 0.0
            while i < len(busy) and busy[i][1] <= a:
                i += 1
            j = i
            while j < len(busy) and busy[j][0] < b:
                covered += min(b, busy[j][1]) - max(a, busy[j][0])
                j += 1
            idle += max(b - a - covered, 0.0)
        return idle / 1e6

    def top_ops(self, n: int = 10) -> List[List[Any]]:
        by: Dict[str, float] = collections.defaultdict(float)
        for name, ts, dur in self.device:
            if self.start_us <= ts < self.end_us:
                by[name[:160]] += dur / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List[Any]]:
        """The ``n`` longest stretches with no device activity, each named
        by the host events under way at its middle (outermost annotation >
        innermost operation)."""
        busy = self.busy_intervals()
        edges = [self.start_us] + [x for ab in busy for x in ab] + [self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            under = [(cat, name, ts, dur) for cat, name, ts, dur in self.host
                     if ts <= mid <= ts + dur and name != WINDOW_ANNOTATION]
            notes = sorted((h for h in under if h[0] == "user_annotation"), key=lambda h: -h[3])
            ops = sorted((h for h in under if h[0] != "user_annotation"), key=lambda h: h[3])
            label = " > ".join([h[1] for h in notes[:1]] + [h[1] for h in ops[:1]]) or "host idle"
            out.append([label[:160], (b - a) / 1e6])
        return out


def parse_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    windows = [e for e in events if e.get("name") == WINDOW_ANNOTATION
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError("the trace holds no traced-window annotation")
    w = windows[0]
    start, end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    device = sorted(((e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
                     for e in events if e.get("cat") in GPU_CATS and "ts" in e),
                    key=lambda d: d[1])
    host = [(e["cat"], e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
            for e in events if e.get("cat") in HOST_CATS and "ts" in e
            and float(e["ts"]) < end and float(e["ts"]) + float(e.get("dur", 0.0)) > start]
    return Trace((end - start) / 1e6, start, end, device, host)


def traced(run: Run, fn: Callable[[], None], units: int) -> Trace:
    """``fn`` called ``units`` times under the profiler (host and device
    activity), inside one annotation that ends after the device is done;
    the trace is written to a temporary file, reduced and deleted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    run.sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW_ANNOTATION):
            for _ in range(units):
                fn()
            run.sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return parse_chrome_trace(path)
    finally:
        os.unlink(path)


# --------------------------------------------------------------------------
# comparison helpers
# --------------------------------------------------------------------------

class tf32_off:
    """Float32 products in float32, not TF32, inside the block (the
    reference's precision); ``tf32_off(False)`` allows TF32 instead."""

    def __init__(self, off: bool = True):
        self.allow = not off

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.allow

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Sequence[str]] = None) -> Tuple[float, str]:
    """The worst leaf's gap between two norms, |prog - ref| over the larger
    of the reference's norm of that leaf and of the median leaf, and its
    name."""
    names = list(ref) if leaves is None else list(leaves)
    med = statistics.median(ref[k] for k in names)
    worst, which = 0.0, ""
    for k in names:
        denom = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / denom if denom > 0 else float("inf")
        if not gap <= worst:
            worst, which = gap, k
    return worst, which


def judge(run: Run, values: Dict[str, float]) -> None:
    """Each number the cell's workload file gives a limit is compared; the
    others are kept as readings."""
    limits = run.cell.workload.get("limits", {})
    for name, value in values.items():
        if name in limits:
            run.check(name, value, limits[name])
        else:
            run.info[name] = value


def busy_share_pct(run: Run, pattern: str) -> Optional[float]:
    """The share of the traced device busy time in operations whose name
    matches ``pattern``, in %; None without a trace."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.trace.kernel_time_s(pattern)[0] / run.trace.busy_s


def idle_pct(run: Run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def idle_ms_per_unit(run: Run, annotation: str) -> Optional[float]:
    """Device idle milliseconds under the host's ``annotation`` spans, per
    traced unit of the cell (a train step); None without a trace."""
    units = run.counts.get("traced_units")
    if run.trace is None or not units:
        return None
    return 1e3 * run.trace.idle_s_under(annotation) / units


def mfu_pct(run: Run, rate_metric: str) -> Optional[float]:
    """Model FLOPs per image x the window's images per second over the
    configuration's peak, in %."""
    rate = run.e2e.get(rate_metric)
    if rate is None or "flops_per_image" not in run.counts:
        return None
    return 100.0 * run.counts["flops_per_image"] * rate / run.counts["peak_flops"]


def kernel_roofline_pct(run: Run) -> Optional[float]:
    """The summed roofline bounds of the port's kernel calls in the traced
    segment over their summed device time, in %; None when the trace holds
    another number of them than the path makes (a kernel taken off it)."""
    c = run.counts
    if run.trace is None or "kernel_bound_per_unit_s" not in c:
        return None
    seconds, launches = run.trace.kernel_time_s(c["kernel_pattern"])
    if launches != c["kernel_calls_per_unit"] * c["traced_units"] or seconds <= 0:
        return None
    return 100.0 * c["kernel_bound_per_unit_s"] * c["traced_units"] / seconds


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else float("inf")


# --------------------------------------------------------------------------
# the result line
# --------------------------------------------------------------------------

def result_line(run: Run, metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                breakdown: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {"correct": run.correct, "attempted": int(run.attempted),
                           "failed": int(run.failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["readings"] = {**run.info, "e2e": run.e2e}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out
