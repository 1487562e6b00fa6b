"""What the benchmark may import, and what it does without a card."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from cardbench import harness

ROOT = Path(__file__).resolve().parents[1]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["collaborative_gan_sampling_torch", "collaborative_gan_sampling_torch"
         ".ops", "jaxtyping", "flaxen", "torch"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "collaborative_gan_sampling_tpu.ops", "flax",
         "jaxlib"]) == ["collaborative_gan_sampling_tpu", "flax", "jax",
                        "jaxlib"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        assert not harness.forbidden_modules(_imports(path)), path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert "collaborative_gan_sampling_torch" not in tops, path


def test_run_without_a_card_fails_with_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "run.py"), "--workload",
         "mnist.refine_b2048", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"printed a result: {line}")
    assert "needs 1 CUDA card" in out.stderr


def test_run_outside_the_repository_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and cardbench/, the run
    prints no result and exits non-zero (here at its look for a card; on
    the card at the missing port's import)."""
    import shutil

    shutil.copytree(ROOT, tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", "mnist.collab",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and not out.stdout.strip()
