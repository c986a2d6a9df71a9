"""The port's serving export (``tpgan_tpu_torch.serving``) on the CPU, at fm
0.25 — the mirrors of ``tests/test_serving.py``: the synthesis function
exported with ``torch.export`` to a ``.pt2`` and loaded back (float32,
int8, bf16-stored weights), ``aot_compile_synthesis``, the full-stack
frontalize artifact (float32 and int8), and a fresh interpreter that
imports torch alone running the float32 and int8 artifacts.

Bars: an artifact against the live program within ARTIFACT_TOL of the
live output's largest magnitude (both run the same ops; the artifact's
fuse is the plain version, bit-equal to the kernel); lm5 within 1e-4 px;
the bf16-weight artifact equal to the live bf16 program and within 0.1 of
the float32-weight one, at under 0.65 of its size (JAX's bars)."""

import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.frontalize import make_frontalize_fn
from tpgan_tpu_torch.models.generator import Generator
from tpgan_tpu_torch.ops import kernels, quant
from tpgan_tpu_torch.serving import (
    aot_compile_synthesis,
    cast_float_leaves,
    export_frontalize,
    export_synthesis,
    load_synthesis,
    with_weights_dtype,
)
from tpgan_tpu_torch.train.gan_trainer import (
    build_generator,
    make_int8_synthesize_fn,
    make_synthesize_fn,
)
from tpgan_tpu_torch.train.pretrain import build_detector

torch.set_num_threads(1)

SMALL = {"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16},
         "D": {"fm_multiplier": 0.25}}
CFG = make_config({**SMALL, "compute_dtype": "float32"})
ARTIFACT_TOL = 1e-5
SHAPES = {"img": (128, 128), "left_eye": (40, 40), "right_eye": (40, 40), "nose": (32, 40),
          "mouth": (32, 48)}


def _inputs(b=2):
    rng = np.random.RandomState(0)
    batch = {k: rng.randn(b, h, w, 3).astype(np.float32) for k, (h, w) in SHAPES.items()}
    return batch, np.zeros((b, 64), np.float32)


def _close(got, want, tol=ARTIFACT_TOL):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol * float(want.abs().max()), (
        float((got - want).abs().max()))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The float32 and int8 synthesis artifacts of one seeded generator,
    exported once for the module."""
    root = tmp_path_factory.mktemp("serving")
    gen = build_generator(CFG, "cpu", seed=0)
    batch, z = _inputs()
    scales = quant.calibrate_synthesis(CFG, gen, [batch], zs=[z])
    paths = {"fp32": str(root / "synthesis.pt2"), "int8": str(root / "synthesis_int8.pt2")}
    fuses = []  # the fuse wrapper's calls while exporting
    real = kernels.fuse_parts
    with mock.patch("tpgan_tpu_torch.models.generator.fuse_parts",
                    lambda *a: fuses.append(1) or real(*a)):
        export_synthesis(CFG, gen, paths["fp32"], batch=2)
        export_synthesis(CFG, gen, paths["int8"], batch=2, quant_scales=scales)
    loaded = {k: load_synthesis(p) for k, p in paths.items()}
    return dict(root=root, gen=gen, scales=scales, paths=paths, loaded=loaded, fuses=fuses)


def test_export_roundtrip(artifacts):
    batch, z = _inputs()
    out = artifacts["loaded"]["fp32"](batch, z)
    assert out.shape == (2, 128, 128, 3)
    _close(out, make_synthesize_fn(CFG, artifacts["gen"])(batch, z))


def test_aot_compile(artifacts):
    compiled = aot_compile_synthesis(CFG, artifacts["gen"], batch=2)
    batch, z = _inputs()
    out = compiled(batch, z)
    assert out.shape == (2, 128, 128, 3)
    assert torch.equal(out, make_synthesize_fn(CFG, artifacts["gen"])(batch, z))


def test_export_int8_roundtrip(artifacts):
    """The int8 artifact reproduces the live int8 program; its weights are
    int8 buffers, its fuse the plain one."""
    batch, z = _inputs()
    loaded = artifacts["loaded"]["int8"]
    live = make_int8_synthesize_fn(CFG, artifacts["gen"], artifacts["scales"])(batch, z)
    _close(loaded(batch, z), live)
    assert any(v.dtype == torch.int8 for v in loaded.program.state_dict.values())
    assert not Generator.plain_fuse and not artifacts["gen"].plain_fuse


def test_the_artifact_fuse_is_plain_and_live_paths_keep_the_kernel(artifacts, monkeypatch):
    """Exporting sets ``plain_fuse`` on the exported copy only: the exports
    traced no call of the kernel wrapper, the live function still makes
    its three."""
    assert artifacts["fuses"] == []
    calls = []
    real = kernels.fuse_parts
    monkeypatch.setattr("tpgan_tpu_torch.models.generator.fuse_parts",
                        lambda *a: calls.append(1) or real(*a))
    batch, z = _inputs()
    make_synthesize_fn(CFG, artifacts["gen"])(batch, z)
    assert len(calls) == 3


def test_export_consumed_out_of_process(artifacts):
    """A fresh interpreter that imports torch alone (isolated mode: no
    PYTHONPATH, no repo on the path) loads the float32 and int8 artifacts
    and runs them on raw numpy inputs, with no ``tpgan_tpu_torch`` module
    loaded."""
    root = artifacts["root"]
    batch, z = _inputs()
    for k, v in batch.items():
        np.save(root / f"{k}.npy", v)
    np.save(root / "zz.npy", z)
    consumer = root / "consumer.py"
    consumer.write_text(
        "import sys\n"
        "import numpy as np\n"
        "import torch\n"
        "path, data_dir, out_path = sys.argv[1:4]\n"
        "keys = ('img', 'left_eye', 'right_eye', 'nose', 'mouth')\n"
        "batch = {k: torch.from_numpy(np.load(f'{data_dir}/{k}.npy')) for k in keys}\n"
        "z = torch.from_numpy(np.load(f'{data_dir}/zz.npy'))\n"
        "module = torch.export.load(path).module()\n"
        "with torch.inference_mode():\n"
        "    out = module(batch, z)\n"
        "assert not any(m.split('.')[0] in ('tpgan_tpu_torch', 'tpgan_tpu')\n"
        "               for m in sys.modules), 'the framework leaked in'\n"
        "np.save(out_path, out.numpy())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # the two consumers run side by side
    procs = {variant: subprocess.Popen([sys.executable, "-I", str(consumer), path, str(root),
                                        str(root / f"out_{variant}.npy")], env=env, cwd=str(root))
             for variant, path in artifacts["paths"].items()}
    for variant, proc in procs.items():
        assert proc.wait(timeout=300) == 0, variant
        got = np.load(root / f"out_{variant}.npy")
        assert got.shape == (2, 128, 128, 3) and np.isfinite(got).all()
        _close(got, artifacts["loaded"][variant](batch, z))


def test_cast_float_leaves_keeps_batch_norm_statistics():
    cfg = make_config({**SMALL, "G": {**SMALL["G"], "use_batchnorm": True}})
    sd = build_generator(cfg, "cpu", seed=0).state_dict()
    cast = cast_float_leaves(sd, torch.bfloat16)
    assert set(cast) == set(sd)
    for k, v in cast.items():
        if k.endswith(("running_mean", "running_var")):
            assert v.dtype == torch.float32
        elif sd[k].is_floating_point():
            assert v.dtype == torch.bfloat16
        else:
            assert torch.equal(v, sd[k])


def test_export_weights_dtype_bf16(tmp_path):
    """On a bf16-compute model the bf16-stored artifact equals the live
    bf16 program (the conv weights are cast to bf16 at use either way) and
    shrinks to under 0.65 of the float32-stored one."""
    cfg = make_config({**SMALL, "compute_dtype": "bfloat16"})
    gen = build_generator(cfg, "cpu", seed=0)
    batch, z = _inputs()
    p32, p16 = str(tmp_path / "synthesis_f32w.pt2"), str(tmp_path / "synthesis_bf16w.pt2")
    export_synthesis(cfg, gen, p32, batch=2)
    export_synthesis(cfg, gen, p16, batch=2, weights_dtype=torch.bfloat16)
    assert os.path.getsize(p16) < 0.65 * os.path.getsize(p32)
    out = load_synthesis(p16)(batch, z)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, make_synthesize_fn(cfg, gen)(batch, z))
    ref = load_synthesis(p32)(batch, z).float()
    assert float((ref - out.float()).abs().max()) < 0.1


@pytest.fixture(scope="module")
def front():
    det = build_detector(CFG, "cpu", seed=0)
    gen = build_generator(CFG, "cpu", seed=1)
    rng = np.random.RandomState(1)
    return dict(det=det, gen=gen, images=(rng.rand(2, 96, 96, 3) * 255).astype(np.uint8),
                z=np.zeros((2, 64), np.float32))


@pytest.fixture(scope="module")
def front_f32(front, tmp_path_factory):
    """The float32 full-stack artifact of ``front``'s models, exported once
    for the module."""
    path = str(tmp_path_factory.mktemp("frontalize") / "frontalize.pt2")
    export_frontalize(CFG, front["det"], front["gen"], path, batch=2, input_hw=(96, 96),
                      detector_size=128)
    return path


def test_export_frontalize_roundtrip(front, front_f32):
    """The full-stack artifact, uint8 frames in: equal to the live program."""
    fake, lm5, scores = load_synthesis(front_f32)(front["images"], front["z"])
    assert fake.shape == (2, 128, 128, 3) and lm5.shape == (2, 5, 2) and scores.shape == (2, 4)
    live = make_frontalize_fn(CFG, front["det"], front["gen"], detector_size=128)(
        front["images"], front["z"])
    _close(fake, live[0])
    assert float((lm5 - live[1]).abs().max()) <= 1e-4
    _close(scores, live[2])


def test_export_frontalize_leaves_the_callers_models(front, front_f32, monkeypatch):
    """A float32 export (no copy needed for the weights' dtype) still
    exports copies: the caller's generator keeps the kernel fuse (its live
    frontalize makes the three wrapper calls) and both models keep their
    gradients."""
    assert not front["gen"].plain_fuse
    assert all(p.requires_grad for p in front["gen"].parameters())
    assert all(p.requires_grad for p in front["det"].parameters())
    calls = []
    real = kernels.fuse_parts
    monkeypatch.setattr("tpgan_tpu_torch.models.generator.fuse_parts",
                        lambda *a: calls.append(1) or real(*a))
    make_frontalize_fn(CFG, front["det"], front["gen"], detector_size=128)(
        front["images"], front["z"])
    assert len(calls) == 3


def test_export_frontalize_int8_roundtrip(front, tmp_path):
    """The int8 generator stage (bf16 rescale) behind the float detector,
    with the detector's parameters stored in bf16 and computed in float32:
    equal to the live program on the same narrowed detector."""
    batch, z = _inputs()
    scales = quant.calibrate_synthesis(CFG, front["gen"], [batch], zs=[z])
    path = str(tmp_path / "frontalize_int8.pt2")
    export_frontalize(CFG, front["det"], front["gen"], path, batch=2, input_hw=(96, 96),
                      detector_size=128, quant_scales=scales, rescale_dtype=torch.bfloat16,
                      weights_dtype=torch.bfloat16)
    loaded = load_synthesis(path)
    fake, lm5, _scores = loaded(front["images"], front["z"])
    assert fake.shape == (2, 128, 128, 3) and torch.isfinite(fake).all()
    state = loaded.program.state_dict
    assert any(v.dtype == torch.bfloat16 for k, v in state.items() if "detector" in k)
    det16 = with_weights_dtype(front["det"], torch.bfloat16, torch.float32)
    live = make_frontalize_fn(CFG, det16, front["gen"], detector_size=128, quant_scales=scales,
                              quant_rescale_dtype=torch.bfloat16)(front["images"], front["z"])
    _close(fake, live[0])
    assert float((lm5 - live[1]).abs().max()) <= 1e-4
