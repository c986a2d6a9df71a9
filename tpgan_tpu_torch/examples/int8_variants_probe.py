"""On-card A/B of the int8 synthesis — the port of
``examples/int8_variants_probe.py``:

* **variants** of ``gan_trainer.make_int8_synthesize_fn``'s knobs against
  the bf16 synthesis, each as graphed images/s with the bench's chain of
  dependent forwards (``tpgan_tpu_torch.bench.measure``), on one
  calibration (one batch-16 bench batch): ``rescale_dtype`` float32 or
  bfloat16, ``min_channels`` 0, 96 or 128;
* **per layer**: for each distinct conv and transposed-conv shape of the
  full-size (fm 1.0) generator at batch 8, the layer's int8 forward
  (quantize, the int8 columns, ``torch._int_mm``, the rescale and bias)
  against the same layer's bf16 forward (cuDNN), in µs per call
  (``utils.timing.gpu_time_ms``, inputs warm), and how many times a
  forward calls it: does ``torch._int_mm`` win anywhere?

    python -m tpgan_tpu_torch.examples.int8_variants_probe [--batch 256] [--scan 20]
    python -m tpgan_tpu_torch.examples.int8_variants_probe --layers-only

Prints one JSON line per variant and per layer shape, then the summary.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import json
from typing import Dict, List

import torch

from tpgan_tpu_torch import bench
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.ops import quant
from tpgan_tpu_torch.ops.blocks import Conv2d, ConvTranspose2d, compute_copy
from tpgan_tpu_torch.train.gan_trainer import (
    build_generator,
    make_graphed_int8_synthesize_fn,
    make_graphed_synthesize_fn,
)
from tpgan_tpu_torch.utils import timing

LAYER_BATCH = 8
LAYER_ITERS = 50
VARIANTS = {  # name: make_int8_synthesize_fn knobs (None: the bf16 synthesis)
    "bf16_reference": None,
    "int8_f32rescale_all": {},
    "int8_bf16rescale_all": {"rescale_dtype": torch.bfloat16},
    "int8_bf16rescale_min96": {"rescale_dtype": torch.bfloat16, "min_channels": 96},
    "int8_bf16rescale_min128": {"rescale_dtype": torch.bfloat16, "min_channels": 128},
    "int8_f32rescale_min128": {"min_channels": 128},
}


def variants(device, batch: int, scan_len: int) -> Dict[str, float]:
    """{variant: graphed images/s at ``batch``} (the bench's chain)."""
    cfg = make_config({"compute_dtype": "bfloat16"})
    gen = build_generator(cfg, device, seed=0)
    scales = quant.calibrate_synthesis(
        cfg, gen, [bench.bench_batch(bench.CALIBRATION_BATCH, device)])
    out = {}
    for name, knobs in VARIANTS.items():
        fn = (make_graphed_synthesize_fn(cfg, gen) if knobs is None
              else make_graphed_int8_synthesize_fn(cfg, gen, scales, **knobs))
        out[name] = round(bench.measure(fn, batch, device, scan_len), 1)
        print(json.dumps({name: out[name]}), flush=True)
        del fn
        torch.cuda.empty_cache()
    return out


def layer_shapes(gen, batch: Dict[str, torch.Tensor], z: torch.Tensor) -> List[dict]:
    """Each distinct conv / transposed-conv call of one forward of ``gen``:
    the layer (a module of ``gen``), its input shape and its calls."""
    seen: Dict[tuple, dict] = {}
    hooks = []

    def record(layer, args):
        x = args[0]
        kind = type(layer).__name__
        key = (kind, tuple(x.shape), tuple(layer.weight.shape), layer.stride,
               getattr(layer, "padding", None), getattr(layer, "reflect", None),
               getattr(layer, "output_padding", None), getattr(layer, "groups", 1))
        if key in seen:
            seen[key]["calls"] += 1
        else:
            seen[key] = {"layer": layer, "input": tuple(x.shape), "calls": 1, "kind": kind}

    for m in gen.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            hooks.append(m.register_forward_pre_hook(record))
    try:
        with torch.inference_mode():
            gen(*(batch[k].permute(0, 3, 1, 2).contiguous() for k in quant.SYNTHESIS_KEYS), z)
    finally:
        for h in hooks:
            h.remove()
    return list(seen.values())


def _holder(layer) -> torch.nn.Module:
    holder = torch.nn.Module()
    holder.layer = copy.deepcopy(layer)
    return holder


def layer_ab(device, batch_size: int = LAYER_BATCH, iters: int = LAYER_ITERS,
             log=print) -> List[dict]:
    """The per-layer A/B at ``batch_size``: one row per distinct conv shape
    of the fm-1.0 generator (seed 0), the layer's bf16 forward (cuDNN)
    and its int8 forward on the same bf16 input (absmax its own), µs
    per call. Logs one JSON line per row."""
    cfg = make_config({"compute_dtype": "bfloat16"})
    gen = build_generator(cfg, device, seed=0)
    batch = bench.bench_batch(batch_size, device)
    z = torch.zeros((batch_size, cfg.G.zdim), device=device)
    card = timing.card_info()
    rows = []
    for i, shape in enumerate(layer_shapes(gen, batch, z)):
        x = torch.randn(shape["input"], generator=torch.Generator(device=device).manual_seed(i),
                        device=device).to(torch.bfloat16)
        float_holder = compute_copy(_holder(shape["layer"]), torch.bfloat16)
        int8_holder = _holder(shape["layer"])
        int8_holder.layer.quant_absmax = x.float().abs().amax()
        quant.quant_mode(int8_holder, quant.INT8)
        with torch.no_grad():
            quant.prepare_int8(int8_holder)
        int8_holder = compute_copy(int8_holder, torch.bfloat16)  # its input stays bf16
        bf16_layer, int8_layer = float_holder.layer.eval(), int8_holder.layer.eval()
        with torch.inference_mode():
            bf16_us = timing.gpu_time_ms(lambda: bf16_layer(x), iters) * 1e3
            int8_us = timing.gpu_time_ms(lambda: int8_layer(x), iters) * 1e3
        layer = shape["layer"]
        row = {"kind": shape["kind"], "input": list(shape["input"]),
               "weight": list(layer.weight.shape), "stride": list(layer.stride),
               "calls_per_forward": shape["calls"], "bf16_us": round(bf16_us, 2),
               "int8_us": round(int8_us, 2), "int8_over_bf16": round(int8_us / bf16_us, 3),
               "winner": "int8" if int8_us < bf16_us else "bf16", "device": card}
        rows.append(row)
        log(json.dumps(row))
        del float_holder, int8_holder, x
    return rows


def summary(rows: List[dict]) -> dict:
    """Per forward: the summed µs of each form over the rows (each times
    its calls), and the rows int8 wins."""
    bf16 = sum(r["bf16_us"] * r["calls_per_forward"] for r in rows)
    int8 = sum(r["int8_us"] * r["calls_per_forward"] for r in rows)
    return {"shapes": len(rows), "int8_wins": sum(r["winner"] == "int8" for r in rows),
            "bf16_us_per_forward": round(bf16, 1), "int8_us_per_forward": round(int8, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--scan", type=int, default=20)
    ap.add_argument("--layers-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_variants_probe needs a CUDA device")
    device = torch.device("cuda")
    out = {"device": timing.card_info()}
    if not args.layers_only:
        out["batch"] = args.batch
        out["imgs_per_sec"] = variants(device, args.batch, args.scan)
    out["layers"] = summary(layer_ab(device))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
