"""``correct`` on the CPU, each cell cut to a CPU's size (the widths stay,
the batch shrinks): a sound run of the program is correct; the
lower-precision control, read in the program's place, fails one of the
cell's numbers; and with the timed path broken underneath (a state the
step returns unchanged, half the batch left out, an answer altered where
it is produced) the run comes out not correct."""

from __future__ import annotations

import pytest
import torch

from bench_h100 import calibrate
from conftest import run_on_cpu


def fails_a_limit(run, readings) -> bool:
    limits = run.cell.workload["limits"]
    return any(readings[name] > limit for name, limit in limits.items() if name in readings)


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    """One sound run per cell, kept for the control readings."""
    import shutil

    from conftest import ROOT

    runs = {}
    for cell in ("tpgan-train-b50", "mnv2-pretrain-b64", "tpgan-serve-b128", "tpgan-serve-b8"):
        root = tmp_path_factory.mktemp(cell)
        shutil.copy(ROOT / "BENCHMARK.json", root)
        shutil.copytree(ROOT / "bench_h100", root / "bench_h100",
                        ignore=shutil.ignore_patterns("__pycache__"))
        runs[cell] = run_on_cpu(root, cell, trace=True)
    return runs


@pytest.mark.parametrize("cell", ["tpgan-train-b50", "mnv2-pretrain-b64", "tpgan-serve-b128",
                                  "tpgan-serve-b8"])
def test_a_sound_run_is_correct_and_reports_its_metrics(sound, cell):
    run, per_layer = sound[cell]
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    assert set(run.e2e) >= {"setup_s", "peak_device_gib"} and len(run.e2e) == 3
    assert run.trace is not None and run.trace.window_s > 0
    # device readings do not exist on the CPU: those readers find nothing
    assert all(per_layer[m] is None for m in per_layer if "roofline" in m or "layout" in m)


def _variants(run):
    from bench_h100 import harness

    driver = harness.load_module(harness.BENCH / "drivers" / f"{run.cell.traffic['driver']}.py",
                                 "driver")
    return calibrate.variants(run, driver)


@pytest.mark.parametrize("cell,control", [("mnv2-pretrain-b64", "control_bf16"),
                                          ("tpgan-serve-b128", "control_fp8"),
                                          ("tpgan-serve-b8", "control_fp8")])
def test_the_control_fails_a_number(sound, cell, control):
    run, _ = sound[cell]
    readings = _variants(run)
    assert fails_a_limit(run, readings[control]), readings[control]


def test_the_gan_control_reads_farther_from_the_reference_than_the_program(sound):
    """The GAN step's fp8 control fails its numbers on the chip on most
    seeds but not all, and at the CPU's size not at all: its step-1 norms
    overlap a bf16 run's within a factor of 3. What holds at every size is
    that it reads farther from the reference than the program does."""
    run, _ = sound["tpgan-train-b50"]
    control = _variants(run)["control_fp8"]
    program = {**run.info, **{k: v for k, (v, _) in run.checks.items()}}
    for name in ("loss1_gap", "grad1_gap"):
        assert control[name] > program[name], (name, control[name], program[name])


def _unchanged_gan(make):
    def build(*args, **kwargs):
        step = make(*args, **kwargs)

        def unchanged(state, batch, generator, noise=None):
            kept = [(p, p.detach().clone()) for p in (*state.gen.parameters(),
                                                      *state.disc.parameters())]
            out = step(state, batch, generator, noise)
            with torch.no_grad():
                for p, v in kept:
                    p.copy_(v)
                for opt in (state.g_opt, state.d_opt):
                    for st in opt.state.values():
                        for t in st.values():
                            if torch.is_tensor(t):
                                t.zero_()
            return out

        unchanged.mesh = step.mesh
        return unchanged
    return build


def _half_gan(make):
    def build(*args, **kwargs):
        step = make(*args, **kwargs)

        def half(state, batch, generator, noise=None):
            h = next(iter(batch.values())).shape[0] // 2
            return step(state, {k: v[:h] for k, v in batch.items()}, generator, noise)

        half.mesh = step.mesh
        return half
    return build


def _unchanged_detector(make):
    def build(cfg, model, opt, *args, **kwargs):
        step = make(cfg, model, opt, *args, **kwargs)

        def unchanged(state, images, labels, generator=None, **kw):
            kept = [(p, p.detach().clone()) for p in model.parameters()]
            out = step(state, images, labels, generator, **kw)
            with torch.no_grad():
                for p, v in kept:
                    p.copy_(v)
                for st in opt.state.values():
                    for t in st.values():
                        if torch.is_tensor(t):
                            t.zero_()
            return out
        return unchanged
    return build


def _half_detector(make):
    def build(*args, **kwargs):
        step = make(*args, **kwargs)

        def half(state, images, labels, generator=None, **kw):
            h = images.shape[0] // 2
            return step(state, images[:h], labels[:h], generator, **kw)
        return half
    return build


def _altered_answer(make):
    def build(*args, **kwargs):
        synthesize = make(*args, **kwargs)

        def altered(batch, z):
            out = synthesize(batch, z)
            return torch.cat([out[1:2], out[0:1], out[2:]])
        return altered
    return build


FAULTS = [
    ("tpgan-train-b50", "tpgan_tpu_torch.train.gan_trainer", "make_gan_train_step",
     _unchanged_gan),
    ("tpgan-train-b50", "tpgan_tpu_torch.train.gan_trainer", "make_gan_train_step", _half_gan),
    ("mnv2-pretrain-b64", "tpgan_tpu_torch.train.pretrain", "make_pretrain_step",
     _unchanged_detector),
    ("mnv2-pretrain-b64", "tpgan_tpu_torch.train.pretrain", "make_pretrain_step",
     _half_detector),
    ("tpgan-serve-b128", "tpgan_tpu_torch.train.gan_trainer", "make_graphed_synthesize_fn",
     _altered_answer),
    ("tpgan-serve-b8", "tpgan_tpu_torch.train.gan_trainer", "make_graphed_synthesize_fn",
     _altered_answer),
]


@pytest.mark.parametrize("cell,module,name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, _, _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(checkout, monkeypatch, cell, module, name, fault):
    import importlib

    target = importlib.import_module(module)
    monkeypatch.setattr(target, name, fault(getattr(target, name)))
    run, _ = run_on_cpu(checkout, cell)
    assert not run.correct, run.checks
