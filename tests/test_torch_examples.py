"""The examples_torch/ scripts, the port's counterparts of examples/, must
stay runnable. Each runs in a subprocess (fresh import state) with
``--device cpu``, NITERS shrunk and cwd in a tmp dir so their relative
``runs/`` output lands in the sandbox, as ``tests/test_examples.py`` runs
the JAX ones."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXAMPLES = [
    "quickstart_2d.py",
    "shaped_d_reuse.py",
    "custom_data.py",
    "inception_fid.py",
    "export_serving.py",
    "migrate_tf1.py",
]


def test_every_example_has_a_counterpart():
    assert sorted(EXAMPLES) == sorted(
        f for f in os.listdir(os.path.join(REPO, "examples"))
        if f.endswith(".py"))
    assert sorted(EXAMPLES) == sorted(
        f for f in os.listdir(os.path.join(REPO, "examples_torch"))
        if f.endswith(".py"))


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_runs(script, tmp_path):
    env = dict(os.environ)
    env["NITERS"] = "50"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["MPLBACKEND"] = "Agg"
    # One torch thread, as the port's other tests run (``one_torch_thread``):
    # beside the suite's busy workers the default pool oversubscribes the
    # cores (quickstart_2d 285 s against 11 s alone, 8 cores, 6 workers).
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples_torch", script),
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
