"""Where a process's first full-size f32 train step on the card differs in
its last bits from the steps after it (ROADMAP C2).

    python -m tpgan_tpu_torch.examples.first_step_bisect             # every mode
    python -m tpgan_tpu_torch.examples.first_step_bisect MODE JSON   # one

(JSON: the file ``shapes`` writes, which ``conv``, ``conv_gp`` and
``gemm`` read; the phase modes take any path.)

Each mode runs in a fresh process, TF32 off and cuDNN deterministic (no
benchmark), as ``chip_smoke.py``'s f32 phase runs, and does the same work
three times, each time from the same seeded state, batch (8) and noise:

* ``step`` — the whole train step, D and G updates;
* ``d`` — the D phase alone (a no-grad generator forward, the critic on
  real, fake and GP images, the WGAN-GP loss's D gradients);
* ``d_wgan`` / ``d_gp`` — the D phase with only the Wasserstein term /
  only the gradient penalty in its loss (the other replaced by a zero
  that takes no gradient);
* ``d_one_thread`` — the D phase with autograd's device threads off
  (``torch.autograd.set_multithreading_enabled(False)``: every backward
  node runs on the calling thread);
* ``g`` — the G phase alone, against the seeded critic;
* ``conv`` — every distinct convolution of the step (as ``shapes``
  records it), one library call each: the forward, then the input and
  weight gradients (cuDNN's fprop, dgrad and wgrad);
* ``conv_gp`` — every distinct ``conv2d`` of the step differentiated
  twice, as the gradient penalty does: the input gradient with
  ``create_graph``, then the gradients of a product with it with respect
  to the weight and the upstream gradient;
* ``gemm`` — every distinct linear layer of the step: its matmul and the
  input and weight gradients (cuBLAS).

``shapes`` (run first, in its own process) records the convolutions and
linear layers one train step makes. Each mode prints one JSON line: how
many gradient (or output) elements of run 1 differ from run 2, and of run 2
from run 3, with the worst leaf's max|diff| over its max|value|; for
``conv`` and ``gemm`` the calls whose first run differs.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

BATCH = 8
MODES = ("step", "d", "d_wgan", "d_gp", "d_one_thread", "g", "conv", "conv_gp", "gemm")


def _settings() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _fresh(dev):
    """(state, step, batch on the device, generator): the seeded f32 set-up
    of ``chip_smoke.py``'s f32 phase."""
    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.train.gan_trainer import create_gan_state, make_gan_train_step

    cfg = make_config({"compute_dtype": "float32"})
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_gan_batch(BATCH, seed=5).items()}
    return state, make_gan_train_step(cfg, gen, disc, g_opt, d_opt), batch, \
        torch.Generator(device=dev).manual_seed(9)


def _grads(state):
    named = [*state.gen.named_parameters(), *(("D." + n, p) for n, p in state.disc.named_parameters())]
    return {n: p.grad.detach().clone() for n, p in named if p.grad is not None}


def _gap(a, b):
    """(elements of a that differ from b, worst leaf's max|a - b| / max|b|,
    {leaf: elements that differ} for the leaves that do)."""
    ndiff, worst, leaves = 0, 0.0, {}
    for n, want in b.items():
        differ = int((a[n] != want).sum())
        ndiff += differ
        if differ:
            leaves[n] = differ
        scale = float(want.abs().max())
        if scale > 0:
            worst = max(worst, float((a[n] - want).abs().max()) / scale)
    return ndiff, worst, leaves


def _phase_runs(dev, mode):
    from tpgan_tpu_torch.train import gan_trainer

    zero = lambda *args: torch.zeros((), device=dev)  # a loss term with no gradient
    only = {"d_wgan": lambda: mock.patch.object(gan_trainer, "gradient_penalty", zero),
            "d_gp": lambda: mock.patch.object(gan_trainer, "discriminator_loss", zero),
            "d_one_thread": lambda: torch.autograd.set_multithreading_enabled(False)}
    runs, values = [], []
    for _ in range(3):
        state, step, batch, generator = _fresh(dev)
        if mode == "step":
            _, metrics = step(state, batch, generator)
        else:
            nchw, (z, gp_eps, mask_d, mask_g) = step.prepare(batch, generator)
            if mode == "g":
                g_loss, metrics = step.g_phase(nchw, z, mask_g)
                metrics = {"g_loss": g_loss, **metrics}
            else:
                with only.get(mode, contextlib.nullcontext)():
                    metrics = step.d_phase(nchw, z, gp_eps, mask_d)
        torch.cuda.synchronize()
        runs.append(_grads(state))
        values.append({k: float(v.detach()) for k, v in metrics.items()})
        del state, step
    return runs, values


def _record_shapes(dev, path):
    """Run one train step with hooks on F.conv2d, F.conv_transpose2d and
    F.linear; write the distinct calls' argument shapes to ``path``."""
    seen = {}
    originals = {"conv2d": F.conv2d, "conv_transpose2d": F.conv_transpose2d, "linear": F.linear}

    def spy(name):
        def call(x, weight, bias=None, *args, **kwargs):
            key = json.dumps([name, list(x.shape), list(weight.shape), bias is not None,
                              [list(a) if isinstance(a, tuple) else a for a in args],
                              {k: list(v) if isinstance(v, tuple) else v
                               for k, v in sorted(kwargs.items())}])
            seen[key] = seen.get(key, 0) + 1
            return originals[name](x, weight, bias, *args, **kwargs)
        return call

    state, step, batch, generator = _fresh(dev)
    for name in originals:
        setattr(F, name, spy(name))
    try:
        step(state, batch, generator)
    finally:
        for name, fn in originals.items():
            setattr(F, name, fn)
    Path(path).write_text(json.dumps([json.loads(k) + [n] for k, n in seen.items()]))


def _call_diffs(dev, calls, kinds, twice=False):
    """Each recorded call of ``kinds``, three times on the same seeded
    inputs: {call: ({output, dgrad, wgrad: elements of run 1 that differ
    from run 2}, elements of run 2 that differ from run 3)}; ``twice``:
    the double backward's results instead."""
    gen = torch.Generator(device=dev)
    diffs = {}
    for name, xs, ws, has_bias, args, kwargs, _count in calls:
        if name not in kinds:
            continue
        gen.manual_seed(len(diffs))
        x = torch.randn(xs, device=dev, generator=gen, requires_grad=True)
        w = torch.randn(ws, device=dev, generator=gen, requires_grad=True)
        b = torch.randn(ws[1] if name == "conv_transpose2d" else ws[0], device=dev,
                        generator=gen) if has_bias else None
        args = [tuple(a) if isinstance(a, list) else a for a in args]
        kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}
        runs = []
        for _ in range(3):
            y = getattr(F, name)(x, w, b, *args, **kwargs)
            if twice:  # the gradient penalty's double backward
                dy = torch.ones_like(y, requires_grad=True)
                (gx,) = torch.autograd.grad(y, x, dy, create_graph=True)
                gw, gdy = torch.autograd.grad((gx * x.detach()).sum(), (w, dy))
                runs.append({"dgrad": gx.detach(), "wgrad_of_dgrad": gw, "dy_of_dgrad": gdy})
            else:
                gx, gw = torch.autograd.grad(y, (x, w), torch.ones_like(y))
                runs.append({"out": y.detach(), "dgrad": gx, "wgrad": gw})
            torch.cuda.synchronize()
        differ = lambda r, s: {k: int((r[k] != s[k]).sum()) for k in r}
        diffs[f"{name} x{xs} w{ws} {args} {kwargs}"] = (differ(runs[0], runs[1]),
                                                        sum(differ(runs[1], runs[2]).values()))
    return diffs


def run_mode(mode: str, shapes_path: str, device: str = "cuda") -> dict:
    dev = torch.device(device)
    _settings()
    if mode == "shapes":
        _record_shapes(dev, shapes_path)
        return {"mode": mode, "calls": len(json.loads(Path(shapes_path).read_text()))}
    if mode in ("step", "d", "d_wgan", "d_gp", "d_one_thread", "g"):
        runs, values = _phase_runs(dev, mode)
        (d12, w12, leaves), (d23, w23, _) = _gap(runs[0], runs[1]), _gap(runs[1], runs[2])
        return {"mode": mode, "leaves": len(runs[0]),
                "elements": sum(g.numel() for g in runs[0].values()),
                "run1_vs_run2": {"differ": d12, "worst": w12,
                                 "leaves": dict(sorted(leaves.items())[:12]),
                                 "losses": [k for k in values[0] if values[0][k] != values[1][k]]},
                "run2_vs_run3": {"differ": d23, "worst": w23}}
    calls = json.loads(Path(shapes_path).read_text())
    kinds = {"conv": ("conv2d", "conv_transpose2d"), "conv_gp": ("conv2d",)}.get(mode, ("linear",))
    diffs = _call_diffs(dev, calls, kinds, twice=mode == "conv_gp")
    return {"mode": mode, "calls": len(diffs),
            "first_run_differs": {c: d for c, (d, _) in diffs.items() if any(d.values())},
            "run2_vs_run3_elements_differ": sum(later for _, later in diffs.values())}


def main(argv) -> int:
    """No argument: ``shapes`` then every mode, each in a child process;
    ``MODE SHAPES_JSON``: one mode in this process."""
    if not torch.cuda.is_available():
        print("FAIL: the first-step bisect needs an NVIDIA GPU", flush=True)
        return 2
    if argv:
        print(json.dumps(run_mode(*argv)), flush=True)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        shapes = str(Path(tmp) / "shapes.json")
        me = [sys.executable, "-m", "tpgan_tpu_torch.examples.first_step_bisect"]
        return max(subprocess.run(me + [mode, shapes]).returncode
                   for mode in ("shapes",) + MODES)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
