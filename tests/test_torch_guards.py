"""Import and entry-point guards of the PyTorch port, in subprocesses:
the package never pulls in JAX, the JAX package or pandas, and
chip_smoke.py refuses to run without a CUDA device or without the
package beside it."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "romtime_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "romtime_tpu", "pandas")


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_leaves_jax_and_pandas_out():
    proc = _run(["-c", "import sys, romtime_tpu_torch, "
                 "romtime_tpu_torch.testing.synthetic; "
                 "print(sorted(m for m in sys.modules if m.split('.')[0] "
                 "in ('jax', 'jaxlib', 'pandas', 'romtime_tpu')))"], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py copied into an otherwise empty directory."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
