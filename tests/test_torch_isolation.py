"""The port stands alone: no jax, nothing of ``repro``, imports on a CPU box.

* An AST scan of every file under ``src/repro_torch/`` and of
  ``chip_smoke.py``: no ``import jax`` / ``from jax...``, no ``repro`` or
  ``repro.*`` import (``repro_torch`` is a different top-level name).
* An import sweep of every ``repro_torch`` module, derived from the file
  tree, in this process (torch for the CPU, no nvcc, no GPU): importing
  compiles and loads nothing. Each module is also imported first, on a
  fresh package state, so no import cycle hides behind the order in which
  a caller happens to load modules.
* ``chip_smoke.py`` refuses to run without a CUDA device: a non-zero exit
  and no result line.
"""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    names = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(PORT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return sorted(set(names))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_sees_the_whole_port():
    mods = _modules()
    assert "repro_torch.kernels.bsr_spgemm.kernel" in mods
    assert "repro_torch.core.session" in mods
    assert len(mods) >= 20


@pytest.mark.parametrize("name", _modules())
def test_module_imports_on_cpu(name):
    mod = importlib.import_module(name)
    assert mod.__name__ == name


def test_every_module_imports_first():
    code = ("import importlib, sys\n"
            f"for name in {_modules()!r}:\n"
            "    for m in [m for m in sys.modules\n"
            "              if m.split('.')[0] == 'repro_torch']:\n"
            "        del sys.modules[m]\n"
            "    importlib.import_module(name)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_import_builds_nothing():
    from repro_torch.kernels.bsr_spgemm import kernel
    importlib.import_module("repro_torch")
    assert kernel._lib is None


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
