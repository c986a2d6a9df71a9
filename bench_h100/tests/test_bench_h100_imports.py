"""No module of the benchmark imports JAX, the JAX package or the root
bench script, compared by whole top-level names (``tpgan_tpu_torch`` is
not ``tpgan_tpu``); the reference imports nothing of the port."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from conftest import ROOT

FILES = sorted((ROOT / "bench_h100").rglob("*.py"))
NEVER = {"jax", "jaxlib", "flax", "optax", "orbax", "tpgan_tpu", "bench"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_sees_the_files():
    assert {p.name for p in FILES} >= {"run.py", "harness.py", "tpgan.py", "detector.py"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_nothing_of_the_jax_package(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((ROOT / "bench_h100" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert node.module.split(".")[0] != "tpgan_tpu_torch"
            if node.module.startswith("bench_h100"):
                assert node.module.startswith("bench_h100.reference")
        if isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] != "tpgan_tpu_torch" for a in node.names)


def test_the_harness_check_is_by_whole_top_level_name():
    import sys

    from bench_h100 import harness

    assert "tpgan_tpu_torch" not in harness.forbidden_loaded()
    sys.modules["tpgan_tpu.fake"] = sys.modules["math"]
    try:
        assert harness.forbidden_loaded() == ["tpgan_tpu"]
    finally:
        del sys.modules["tpgan_tpu.fake"]
