"""The benchmark's files are found by name, hold what the contract asks,
and a new cell or per-layer metric needs new files and entries alone."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from bench_h100 import harness
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_by_name_with_its_driver_and_readers(cell):
    c = harness.load_cell(cell)
    assert (harness.BENCH / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert c.config["name"] == c.entry["config"]
    assert {"setup_s", "peak_device_gib"} <= {m["name"] for m in c.end_to_end()}
    assert len(c.end_to_end()) >= 3 and c.per_layer()
    for m in c.per_layer():
        reader = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py", m["name"])
        assert callable(reader.read)
        assert m["moves"] in {e["name"] for e in c.end_to_end()}
    assert c.workload["limits"], "every cell compares at least one number"


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"] and BENCH["command"][1] == "bench_h100/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench_h100/")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    layers = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        layers.add(m["layer"])
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}
    assert layers <= {"entry", "data", "graph", "train step", "models and blocks", "kernels",
                      "device"}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_and_metric_need_new_files_and_entries_alone(checkout):
    """A dummy cell (an existing configuration under new traffic) and a
    dummy per-layer metric, added as files and entries of a temporary copy:
    run.py finds both by name and stops only at the missing card."""
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tpgan-serve-b4", "config": "tpgan-128",
                               "traffic": "closed-b4", "chips": 1, "why": "a dummy cell"})
    bench["per_layer"].append({"name": "dummy_ms.latency", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "entry",
                               "moves": "serve_p95_ms", "workloads": ["tpgan-serve-b4"]})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_p95_ms":
            m["workloads"].append("tpgan-serve-b4")
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    workload = json.loads((checkout / "bench_h100/workloads/tpgan-serve-b8.json").read_text())
    workload["traffic"].update(name="closed-b4", batch=4)
    (checkout / "bench_h100/workloads/tpgan-serve-b4.json").write_text(json.dumps(workload))
    (checkout / "bench_h100/metrics/dummy_ms.latency.py").write_text(
        "def read(run):\n    return run.counts.get('request_ms_p50')\n")

    c = harness.load_cell("tpgan-serve-b4", checkout)
    assert c.traffic["batch"] == 4 and "dummy_ms.latency" in {m["name"] for m in c.per_layer()}
    reader = harness.load_module(checkout / "bench_h100/metrics/dummy_ms.latency.py", "dummy")
    assert reader.read(type("R", (), {"counts": {"request_ms_p50": 9.5}})()) == 9.5
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    found = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", "tpgan-serve-b4",
                            "--seed", "1", "--seconds", "1"], cwd=checkout, env=env,
                           capture_output=True, text=True, timeout=300)
    assert found.returncode == 3 and "needs 1 CUDA device" in found.stderr, found.stderr[-2000:]
    assert found.stdout == ""
    missing = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", "no-such-cell",
                              "--seed", "1", "--seconds", "1"], cwd=checkout, env=env,
                             capture_output=True, text=True, timeout=300)
    assert missing.returncode != 0 and "no cell" in missing.stderr


def test_a_directory_with_the_benchmark_alone_gives_no_result(checkout):
    """Without the port beside it (the copy holds BENCHMARK.json and
    bench_h100/ alone) a run past the card's look fails and prints no
    result."""
    script = ("import sys, time; sys.path.insert(0, '.')\n"
              "from bench_h100 import harness\n"
              "c = harness.load_cell('tpgan-serve-b8')\n"
              "r = harness.Run(c, 1, 1.0, False, time.perf_counter(), device='cpu')\n"
              "d = harness.load_module(harness.BENCH / 'drivers' / 'serve_closed_loop.py', 'd')\n"
              "d.run(r)\n"
              "print('{\"correct\": true}')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=checkout,
                          env={"PATH": "/usr/bin:/bin"}, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "tpgan_tpu_torch" in proc.stderr
    assert '"correct"' not in proc.stdout
