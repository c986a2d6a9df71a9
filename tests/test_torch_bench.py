"""The port's bench (``python -m tpgan_tpu_torch.bench``) without a GPU:
its mode parser takes what the port runs (bf16 and int8, with +subpixel and
int8's +bf16rescale) and refuses the rest (+bf16rescale without int8, the
TPU lane layout, typos), and with no CUDA device
the script prints ``bench.py``'s headline line marked
``all(device_unavailable)`` and exits 0. On the CPU the graphed synthesis
is the eager function, so the bench's chain of dependent forwards gives
the same sum through both."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpgan_tpu_torch import bench
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.train.gan_trainer import (
    build_generator,
    make_graphed_synthesize_fn,
    make_synthesize_fn,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode,upsample,knobs", [
    ("bf16", None, None),
    ("bf16+subpixel", "subpixel", None),
    ("int8", None, {"rescale_dtype": None}),
    ("int8+subpixel+bf16rescale", "subpixel", {"rescale_dtype": torch.bfloat16}),
])
def test_modes_the_port_runs(mode, upsample, knobs):
    overrides = bench.parse_mode(mode)
    assert overrides["compute_dtype"] == "bfloat16"
    assert overrides["G"].get("upsample_mode") == upsample
    assert bench.int8_knobs(mode) == knobs
    make_config(overrides)


@pytest.mark.parametrize("mode,match", [
    ("bf16+bf16rescale", "int8 option"),
    ("bf16+pad", "TPU lane layout"),
    ("bf16+subpixel+pad", "TPU lane layout"),
    ("fp16", "unknown bench mode base"),
    ("bf16+subpxl", "unknown bench mode tokens"),
])
def test_modes_the_port_refuses(mode, match):
    with pytest.raises(ValueError, match=match):
        bench.parse_mode(mode)


def test_without_cuda_the_script_prints_its_failure_line():
    proc = subprocess.run(
        [sys.executable, "-m", "tpgan_tpu_torch.bench"], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["skipped"] == ["all(device_unavailable)"]
    assert line["metric"] == "tpgan_synthesis_imgs_per_sec_per_chip"
    assert line["unit"] == "imgs/s" and line["value"] == 0.0 and line["mode"] is None
    assert line["modes"] == {"int8+subpixel+bf16rescale": None, "bf16": None, "int8": None}


def test_a_typo_fails_before_any_measurement():
    with pytest.raises(ValueError, match="unknown bench mode tokens"):
        bench.main(["--modes", "bf16,bf16+subpxl"])


def test_chain_through_both_forms_on_the_cpu():
    cfg = make_config({"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16},
                       "compute_dtype": "float32"})
    gen = build_generator(cfg, "cpu", seed=0)
    batch = bench.bench_batch(2, "cpu")
    z = torch.zeros((2, cfg.G.zdim))
    graphed = make_graphed_synthesize_fn(cfg, gen)
    eager = make_synthesize_fn(cfg, gen)
    a = bench.chain(graphed, batch, z, scan_len=2)
    b = bench.chain(eager, batch, z, scan_len=2)
    assert torch.equal(a, b) and np.isfinite(float(a))
