"""The readers of the program's spans and its capture seconds: each on a
hand-made trace reads the right milliseconds or seconds, and reads nothing
(None, not 0) when the trace lacks its spans or the program lacks its
number, as a program without them gives; and on the CPU the program's
spans lie inside the benchmark's own."""

from __future__ import annotations

import types

import pytest

from bench_h100 import harness
from conftest import ROOT, run_on_cpu


def reader(name):
    return harness.load_module(ROOT / "bench_h100" / "metrics" / f"{name}.py", name)


def ann(name, ts, dur):
    return ("user_annotation", name, float(ts), float(dur))


# a 1000-us segment, the device busy over [100, 300] and [500, 900]
DEVICE = [("k0", 100.0, 200.0), ("k1", 500.0, 250.0), ("k2", 700.0, 200.0)]
HOST = [
    # idle 50 + 50 under the first, 50 + 50 under the second: 0.2 ms
    ann("graph.dispatch", 50, 300), ann("graph.dispatch", 450, 500),
    # idle 60 + 0 + 40: 0.1 ms; the index copies last 30 + 10 (clipped) us
    ann("data.sample", 0, 60), ann("data.sample", 200, 50), ann("data.sample", 940, 40),
    ann("data.index_copy", 10, 30), ann("data.index_copy", 990, 20),
    # idle 50 + 0 + 200 + 0 + 50: 0.3 ms
    ann("pretrain.forward", 50, 100), ann("pretrain.loss", 200, 100),
    ann("pretrain.backward", 300, 200), ann("pretrain.optimizer", 500, 300),
    ann("pretrain.metrics", 850, 100),
    ("cpu_op", "aten::copy_", 10.0, 30.0),
]
# per traced unit, of two
EXPECTED = {"graph_idle_ms.train": 0.1, "graph_idle_ms.latency": 0.1,
            "sample_idle_ms.train": 0.05, "sample_idle_ms.pretrain": 0.05,
            "index_copy_ms.pretrain": 0.02, "step_idle_ms.pretrain": 0.15,
            "forward_idle_ms.pretrain": 0.025, "loss_idle_ms.pretrain": 0.0,
            "backward_idle_ms.pretrain": 0.1, "optimizer_idle_ms.pretrain": 0.0,
            "metrics_idle_ms.pretrain": 0.025}
PHASES = ("forward", "loss", "backward", "optimizer", "metrics")


def run_of(host, units=2, trace=True):
    t = harness.Trace(1e-3, 0.0, 1000.0, DEVICE, host) if trace else None
    return types.SimpleNamespace(trace=t, counts={"traced_units": units})


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_span_reader_reads_its_spans(name):
    assert reader(name).read(run_of(HOST)) == pytest.approx(EXPECTED[name], abs=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_without_its_spans_a_reader_reads_nothing(name):
    # the trace a program without the spans gives: the benchmark's own and the ops
    parent = [ann("fetch", 0, 60), ann("dispatch", 60, 900),
              ("cpu_op", "aten::copy_", 10.0, 30.0)]
    assert reader(name).read(run_of(parent)) is None
    assert reader(name).read(run_of(HOST, trace=False)) is None
    assert reader(name).read(run_of(HOST, units=0)) is None


@pytest.mark.parametrize("missing", ["pretrain.forward", "pretrain.metrics"])
def test_the_step_reader_needs_all_five_phases(missing):
    host = [h for h in HOST if h[1] != missing]
    assert reader("step_idle_ms.pretrain").read(run_of(host)) is None


def test_the_phases_add_up_to_the_step():
    run = run_of(HOST)
    phases = [reader(f"{p}_idle_ms.pretrain").read(run) for p in PHASES]
    assert sum(phases) == pytest.approx(reader("step_idle_ms.pretrain").read(run), abs=1e-12)


def test_the_capture_reader_reads_the_program_seconds(monkeypatch):
    from tpgan_tpu_torch.utils import graphs

    read = reader("graph_capture_s").read
    monkeypatch.setattr(graphs, "capture_seconds", lambda: 3.5)
    assert read(None) == 3.5
    monkeypatch.setattr(graphs, "capture_seconds", lambda: 0.0)  # nothing captured
    assert read(None) is None
    monkeypatch.delattr(graphs, "capture_seconds")  # a program without the number
    assert read(None) is None


@pytest.mark.parametrize("cell,suffix", [("mnv2-pretrain-b64", "pretrain"),
                                         ("tpgan-train-b50", "train")])
def test_the_program_spans_lie_inside_the_benchmark_spans(checkout, cell, suffix):
    """On the CPU (no device activity: idle time is the spans' length) the
    sampler's spans lie inside ``fetch`` and the step's inside ``dispatch``,
    so the inner readers read no more than the outer one."""
    run, readings = run_on_cpu(checkout, cell, trace=True)
    notes = [(name, ts, ts + dur) for cat, name, ts, dur in run.trace.host
             if cat == "user_annotation"]
    outer = {"data.": "fetch", "pretrain.": "dispatch"}
    inner = [n for n in notes if n[0].startswith(tuple(outer))]
    assert {n[0] for n in inner} >= {"data.sample", "data.index_copy"}
    for name, a, b in inner:
        around = outer[name[:name.index(".") + 1]]
        assert any(n == around and x <= a and b <= y for n, x, y in notes), (name, a, b)
    assert readings[f"sample_idle_ms.{suffix}"] is not None
    assert readings[f"sample_idle_ms.{suffix}"] <= readings[f"input_wait_ms.{suffix}"]
    if suffix == "pretrain":
        assert 0 < readings["index_copy_ms.pretrain"] <= readings["sample_idle_ms.pretrain"]
        phases = [readings[f"{p}_idle_ms.pretrain"] for p in PHASES]
        assert None not in phases
        assert sum(phases) == pytest.approx(readings["step_idle_ms.pretrain"])
    else:  # the CPU's multi-step runs eager steps: no graph
        assert readings["graph_idle_ms.train"] is None
