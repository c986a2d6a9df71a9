"""The port's spans (``tpgan_tpu_torch/utils/trace.py``) on the CPU: a span
is a shared no-op unless a profiler records; under one, the device
samplers and the detector step put their spans in the exported trace,
nested and in order. And the kernel builds' seconds, which a graph
capture leaves out of its own."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.data.packing import device_batch_iterator, device_bucketed_batch_iterator
from tpgan_tpu_torch.train import pretrain
from tpgan_tpu_torch.utils import trace

torch.set_num_threads(1)

PRETRAIN_PHASES = ("pretrain.forward", "pretrain.loss", "pretrain.backward",
                   "pretrain.optimizer", "pretrain.metrics")


def _flat_sampler():
    data = {"img": torch.arange(5 * 3 * 4 * 4, dtype=torch.uint8).reshape(5, 4, 4, 3),
            "label": torch.arange(5, dtype=torch.int32)}
    return device_batch_iterator(data, 3, seed=0)


def _bucketed_sampler():
    groups = {(4, 4, 3): {"img": torch.zeros((6, 4, 4, 3), dtype=torch.uint8),
                          "label": torch.zeros((6, 8))},
              (8, 8, 3): {"img": torch.zeros((4, 8, 8, 3), dtype=torch.uint8),
                          "label": torch.zeros((4, 8))}}
    return device_bucketed_batch_iterator(groups, 2, seed=0)


SAMPLERS = {"device_batch_iterator": _flat_sampler,
            "device_bucketed_batch_iterator": _bucketed_sampler}


def _pretrain_call():
    cfg = make_config({"pretrain": {"batch_size": 2}})
    state, model, opt = pretrain.create_pretrain_state(cfg, 0, "cpu", steps_per_epoch=3)
    step = pretrain.make_pretrain_step(cfg, model, opt, state.scheduler)
    rng = np.random.RandomState(0)
    images = (rng.uniform(0, 1, (2, 64, 64, 3)) * 255).astype(np.uint8)
    labels = rng.uniform(20, 44, (2, 8)).astype(np.float32)
    generator = torch.Generator().manual_seed(0)
    return lambda: step(state, images, labels, generator)


def _annotations(prof, tmp_path):
    """(name, start us, end us) of the exported trace's user annotations,
    in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events if e.get("cat") == "user_annotation"]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


@pytest.mark.parametrize("name", ["data.sample", "graph.dispatch", "pretrain.forward"])
def test_a_span_without_a_profiler_is_the_shared_no_op(monkeypatch, name):
    def refuse(*_args, **_kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    s = trace.span(name)
    assert s is trace.NO_SPAN
    with s as entered:
        assert entered is None


@pytest.mark.parametrize("call", ["device_batch_iterator", "device_bucketed_batch_iterator",
                                  "make_pretrain_step"])
def test_the_port_enters_no_record_function_without_a_profiler(monkeypatch, call):
    run = _pretrain_call() if call == "make_pretrain_step" else SAMPLERS[call]().__next__

    def refuse(*_args, **_kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    run()


def test_a_span_under_a_profiler_is_a_record_function(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = trace.span("data.sample")
        assert s is not trace.NO_SPAN
        with s:
            with trace.span("data.index_copy"):
                torch.ones(4).sum()
    (outer, a, b), (inner, c, d) = _annotations(prof, tmp_path)
    assert (outer, inner) == ("data.sample", "data.index_copy") and a <= c <= d <= b


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_one_batch_is_one_sample_span_holding_one_index_copy(tmp_path, sampler):
    batches = SAMPLERS[sampler]()
    next(batches)  # the generator's first steps outside the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        next(batches)
    spans = _annotations(prof, tmp_path)
    assert [name for name, _, _ in spans] == ["data.sample", "data.index_copy"], spans
    (_, a, b), (_, c, d) = spans
    assert a <= c <= d <= b


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_a_sampler_keeps_no_reference_to_the_batch_it_yielded(sampler):
    """A batch lives in device memory: once the caller drops it, nothing of
    the span around its draw keeps it until the next draw."""
    import weakref

    batches = SAMPLERS[sampler]()
    batch = next(batches)
    tensors = batch.values() if isinstance(batch, dict) else batch
    refs = [weakref.ref(t) for t in tensors]
    del batch, tensors
    assert all(r() is None for r in refs)


def test_a_pretrain_step_is_five_phase_spans_in_order(tmp_path):
    call = _pretrain_call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    spans = [s for s in _annotations(prof, tmp_path) if s[0].startswith("pretrain.")]
    assert tuple(name for name, _, _ in spans) == PRETRAIN_PHASES, spans
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start


def test_a_kernel_build_counts_its_seconds_once(monkeypatch, tmp_path):
    """``ops._build`` adds the seconds it spends compiling to
    ``build_seconds()`` (which a graph capture leaves out of its own time),
    and nothing for a source already built."""
    import stat
    import sys

    from tpgan_tpu_torch.ops import _build

    compiler = tmp_path / "nvcc"
    compiler.write_text(f"#!{sys.executable}\n"
                        "import sys, time\n"
                        "time.sleep(0.2)\n"
                        "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    compiler.chmod(compiler.stat().st_mode | stat.S_IEXEC)
    (tmp_path / "k.cu").write_text("// a kernel\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(compiler))
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_build_seconds", 1.0)
    assert _build.build(("k.cu",))["k.cu"].exists()
    built = _build.build_seconds()
    assert 1.2 <= built < 1.0 + 60
    _build.build(("k.cu",))
    assert _build.build_seconds() == built
