"""The PyTorch port stands alone: importing it loads neither jax nor the
JAX package, no source file of it (or chip_smoke.py) imports them, and
its entry points default to the card, refusing to run quietly on the
CPU when there is none. chip_smoke.py fails, printing no result, where
there is no card or no rest of the repo.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.testing import fresh_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")
MODULES = [
    "paddle_tpu_torch",
    "paddle_tpu_torch.convert",
    "paddle_tpu_torch.testing",
    "paddle_tpu_torch.kernels",
    "paddle_tpu_torch.kernels.build",
    "paddle_tpu_torch.models.transformer",
    "paddle_tpu_torch.serving.generation",
    "paddle_tpu_torch.serving.speculative",
    "paddle_tpu_torch.ops.speculative_ops",
    "paddle_tpu_torch.kernels.lstm_cell",
    "paddle_tpu_torch.kernels.gru_cell",
    "paddle_tpu_torch.ops.rnn_ops",
    "paddle_tpu_torch.ops.seq2seq_ops",
    "paddle_tpu_torch.layers.rnn",
    "paddle_tpu_torch.models.stacked_lstm",
    "paddle_tpu_torch.models.machine_translation",
]


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_import_loads_no_jax_and_no_paddle_tpu():
    """In a fresh interpreter (this one has jax loaded by conftest)."""
    code = (
        "import importlib, json, sys\n"
        "for m in %r: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'paddle_tpu' or m.startswith('paddle_tpu.'))))\n" % MODULES)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_child_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield SMOKE


def test_no_source_imports_jax_or_paddle_tpu():
    """Every import statement of the package and of chip_smoke.py names
    neither jax nor paddle_tpu (paddle_tpu_torch is fine)."""
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "paddle_tpu"):
                    bad.append("%s: %s" % (os.path.relpath(path, ROOT),
                                           name))
    assert bad == []


def test_executor_defaults_to_the_card_and_refuses_without_one():
    if torch.cuda.is_available():
        assert tfluid.Executor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.Executor(tfluid.TPUPlace(0))
    assert tfluid.Executor(tfluid.CPUPlace()).device.type == "cpu"


def _run_smoke(cwd):
    env = _child_env()
    if cwd != ROOT:
        env.pop("PYTHONPATH")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _assert_failed_without_result(out):
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    _assert_failed_without_result(_run_smoke(ROOT))


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo, the script fails and prints no result."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    _assert_failed_without_result(_run_smoke(str(tmp_path)))
