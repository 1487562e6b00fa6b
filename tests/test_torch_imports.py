"""The port stands alone: no file of ``collaborative_gan_sampling_torch``, not
``chip_smoke.py``, ``bench_torch.py`` or ``examples_torch/`` and not the
measurement tools (``conv_refine_phases.py``, ``collab_walls.py``) imports
JAX, Flax, Optax, the JAX package, ``bench.py``, ``benchmarks/`` or
``msgpack`` (absent where the port runs on the card: the port reads and
writes Flax checkpoints with its own ``utils/msgpack.py``); its entry
points refuse to run without a card unless the caller asks for the CPU; and
``chip_smoke.py`` fails, printing no result, where there is no card or where
it stands without the rest of the repo, as the tools do without a card."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "collaborative_gan_sampling_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "collaborative_gan_sampling_tpu",
             "msgpack", "bench", "benchmarks")


EXAMPLES = sorted((REPO / "examples_torch").glob("*.py"))


def _port_files():
    files = (sorted(PORT.rglob("*.py")) + EXAMPLES
             + [REPO / "chip_smoke.py", REPO / "conv_refine_phases.py",
                REPO / "collab_walls.py", REPO / "bench_torch.py"])
    assert len(files) > 10
    return files


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_make_bundle_needs_a_card_unless_told(monkeypatch):
    from collaborative_gan_sampling_torch.config import get_preset
    from collaborative_gan_sampling_torch.models import make_bundle

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_bundle(get_preset("mnist").model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_bundle(get_preset("mnist").model, device="cuda")
    assert make_bundle(get_preset("mnist").model,
                       device="cpu").device.type == "cpu"


def test_eval_entry_points_need_a_card_unless_told(monkeypatch):
    """The feature nets, their trainers and Inception-v3 run on the card
    unless the caller asks for the CPU."""
    from collaborative_gan_sampling_torch.evals import features, inception

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda d: features.make_feature_fn("random_conv", (8, 8, 1),
                                               device=d),
            lambda d: features.train_classifier_features(
                lambda g, n: (torch.zeros(n, 8, 8, 1),
                              torch.zeros(n, dtype=torch.long)),
                2, (8, 8, 1), steps=1, batch=2, device=d),
            lambda d: features.train_rotation_features(
                lambda g, n: torch.zeros(n, 8, 8, 1), (8, 8, 1), steps=1,
                batch=2, device=d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
        assert call("cpu")[0](torch.zeros(1, 8, 8, 1)).ndim == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inception.init_inception()


@pytest.mark.parametrize("main", ["main_synthetic", "main_mnist",
                                  "main_celeba"])
def test_compat_mains_need_a_card_unless_told(monkeypatch, tmp_path, main):
    """The reference-flag scripts run on the card unless given
    ``--device cpu``."""
    import importlib

    module = importlib.import_module(
        f"collaborative_gan_sampling_torch.compat.{main}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--mode", "train", "--niters", "1", "--batch_size", "8",
            "--checkpoint_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    if main == "main_synthetic":  # the others load image data first
        assert module.main(argv + ["--device", "cpu"]) == 0


@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.name)
def test_examples_need_a_card_unless_told(monkeypatch, tmp_path, script):
    """Each example script runs on the card unless given ``--device cpu``
    (``tests/test_torch_examples.py`` runs them so); without a card it
    raises before any work."""
    import runpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [str(script)])
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_path(str(script), run_name="__main__")
    assert not (tmp_path / "runs").exists()


def _run_smoke(cwd: Path, script: Path):
    return subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run")
    proc = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    proc = _run_smoke(tmp_path, alone)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_conv_refine_phases_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; conv_refine_phases.py would run")
    proc = _run_smoke(REPO, REPO / "conv_refine_phases.py")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_collab_walls_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; collab_walls.py would run")
    proc = _run_smoke(REPO, REPO / "collab_walls.py")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
