"""Rules of the PyTorch port: it imports nothing of JAX, nothing of
``tpgan_tpu`` (not even its jax-free modules) and no imaging package (the
card's machine is not promised one: the port reads, writes and resizes
images itself, ``data/imageio.py``), and its entry points never drift to
the CPU on their own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.entry import entry, pretrain_entry, train_entry
from tpgan_tpu_torch.examples import conv_ab
from tpgan_tpu_torch.train.feature_extract import (
    create_feature_extract_state,
    run_feature_extract_training,
)
from tpgan_tpu_torch.train.gan_trainer import build_generator, create_gan_state
from tpgan_tpu_torch.train.pretrain import build_detector, create_pretrain_state, run_pretrain

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tpgan_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# PIL: the card's machine is not promised an imaging package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpgan_tpu", "PIL")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "tpgan_tpu_torch." + ".".join(p.relative_to(ROOT / "tpgan_tpu_torch").with_suffix("").parts)
        for p in (ROOT / "tpgan_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU refusal; this host has a GPU")


def test_entry_points_refuse_to_drift_to_cpu(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_generator(make_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_gan_state(make_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conv_ab.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_entry(identity=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_feature_extract_state(make_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_feature_extract_training(make_config(), iter(()), steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_entry(head_mode="anchor_offset")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector(make_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_pretrain_state(make_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pretrain(make_config(), iter(()), steps_per_epoch=1)


def test_padded_channel_layout_is_refused():
    cfg = make_config({"G": {"pad_channel_multiple": 128}})
    with pytest.raises(ValueError, match="pad_channel_multiple"):
        build_generator(cfg, "cpu")
