"""The readings that a cell's limits are set from, on the chip, in one
process: for each seed a full run of the cell (a short window), its
numbers as compared; for each control seed also the lower-precision
control and the planted faults put in the program's place, each read the
same way:

    python3 bench_h100/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 2 --out chiprun_out/calibrate-<cell>.jsonl

* ``gan_train``: the control is the reference with every conv and linear
  input and weight rounded to fp8 e4m3 and the gradient reaching each
  layer's output to e5m2 (per-tensor scales: the nearest precision below
  bfloat16, as fp8 training keeps them); the faults are a step that sees
  half the batch, and a step that returns its state unchanged (no moment,
  no change: read without a run). The look: the reference in the
  program's bfloat16 products.
* ``pretrain``: the control is the reference in bfloat16 products, its
  gradients too (the nearest below the TF32 convs), making its own
  assignment, which the reference then follows as it follows the
  program's; the faults are half the batch and a state unchanged. The
  look: the reference in TF32 products; ``--program-fp32`` runs the
  program with TF32 off as a witness.
* ``serve_*``: the control is the reference with every conv and linear
  input and weight rounded to fp8 e4m3; the program's own int8 synthesis
  is read beside it. The fault is one image of each kept batch swapped
  with another.

Each line of ``--out`` (JSON) is one seed; the last line of standard
output sums them up: per number, the largest program reading and the
smallest control and fault readings.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_h100 import harness  # noqa: E402


def fp8(t: torch.Tensor) -> torch.Tensor:
    """e4m3 with a per-tensor scale, for products' inputs and weights."""
    scale = 448.0 / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


def fp8_grad(t: torch.Tensor) -> torch.Tensor:
    """e5m2 with a per-tensor scale, for the gradients of fp8 training."""
    scale = 57344.0 / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e5m2).to(t.dtype) / scale


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


# the backward products' gradient operand in the same precision
fp8.grad = fp8_grad
bf16.grad = bf16


def numbers(values) -> dict:
    return {k: v for k, v in values.items() if isinstance(v, (int, float))}


def variants(r: harness.Run, driver) -> dict:
    kind = r.cell.traffic["driver"]
    judge = r.judge
    out = {}
    if kind == "gan_train":
        ref = r.judge_ref
        leaves = {"program": r.judge_prog["moment"], "reference": ref["moment"]}
        for name, kw in (("control_fp8", {"rounding": fp8}), ("fault_half_batch",
                                                              {"half_batch": True})):
            reading = judge.follow(**kw)
            out[name] = {**driver.compare(reading, ref), "losses": reading["losses"]}
            leaves[name] = reading["moment"]
        out["fault_unchanged"] = driver.compare(driver.unchanged(ref), ref)
        # the look: the reference itself in the program's bfloat16 products
        look = judge.follow(rounding=bf16)
        out["look_reference_bf16"] = {**driver.compare(look, ref), "losses": look["losses"]}
        leaves["look_reference_bf16"] = look["moment"]
        # each leaf's first-moment norm by source, for choosing a number offline
        out["leaves"] = leaves
    elif kind == "pretrain":
        control = judge.follow(own_assignment=True, rounding=bf16)
        follower = driver.Judge(judge.conf, judge.host, judge.batches, control["locs"],
                                judge.noise_seed, judge.device)
        out["control_bf16"] = numbers(driver.compare(control, follower.follow(), 0.0))
        # the reference cannot follow a half batch's assignment: its own
        half = judge.follow(own_assignment=True, half_batch=True)
        out["fault_half_batch"] = numbers(driver.compare(half, judge.follow(own_assignment=True),
                                                         0.0))
        out["fault_unchanged"] = numbers(driver.compare(driver.unchanged(r.judge_prog),
                                                        r.judge_ref, 0.0))
        # the look: the reference itself with TF32 products, on the program's assignment
        look = driver.compare(judge.follow(tf32=True), r.judge_ref, 0.0)
        out["look_reference_tf32"] = {k: v for k, v in look.items()
                                      if isinstance(v, (int, float, str))}
    else:
        b = r.cell.traffic["batch"]
        reference = judge.reference()
        out["control_int8"] = judge.gaps(judge.int8_outputs(b), reference)
        out["control_fp8"] = judge.gaps(judge.reference(rounding=fp8), reference)
        swapped = [torch.cat([o[1:2], o[0:1], o[2:]]) for _, _, o in judge.samples]
        out["fault_swapped_image"] = judge.gaps(swapped, reference)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    p.add_argument("--program-fp32", action="store_true",
                   help="a witness, not a sound run: the program's convs and matmuls in "
                        "float32 (TF32 off, and a float32 compute dtype where the "
                        "configuration states one) instead of the configuration's precision")
    args = p.parse_args(argv)
    if args.program_fp32:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload, ROOT)
    if args.program_fp32 and "compute_dtype" in cell.config.get("precision", {}):
        cell.config["precision"]["compute_dtype"] = "float32"
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    driver = harness.load_module(harness.BENCH / "drivers" / f"{cell.traffic['driver']}.py",
                                 cell.traffic["driver"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    summary: dict = {"program": {}, "variants": {}}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for seed in [int(s) for s in args.seeds.split(",")]:
            r = harness.Run(cell, seed, args.seconds, False, time.perf_counter())
            driver.run(r)
            line = {"seed": seed, "e2e": r.e2e, "program_fp32": args.program_fp32,
                    "program": {**{k: v for k, (v, _) in r.checks.items()}, **numbers(r.info)},
                    "info": {k: v for k, v in r.info.items() if not isinstance(v, (int, float))}}
            if cell.traffic["driver"] == "gan_train":
                line["leaves"] = {"program": r.judge_prog["moment"],
                                  "reference": r.judge_ref["moment"]}
            if seed in controls:
                line["variants"] = variants(r, driver)
                if "leaves" in line["variants"]:
                    line["leaves"] = line["variants"].pop("leaves")
            f.write(json.dumps(line) + "\n")
            f.flush()
            for k, v in line["program"].items():
                summary["program"][k] = max(summary["program"].get(k, 0.0), v)
            for name, vals in line.get("variants", {}).items():
                into = summary["variants"].setdefault(name, {})
                for k, v in numbers(vals).items():
                    into[k] = min(into.get(k, float("inf")), v)
            print(json.dumps({"seed": seed, "program": line["program"],
                              "variants": line.get("variants", {}),
                              "setup_s": r.e2e.get("setup_s")}), flush=True)
            del r
            gc.collect()
            torch.cuda.empty_cache()
    print(json.dumps({"summary": summary, "wall_s": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
