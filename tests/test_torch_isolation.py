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
* The serving CLI runs end to end on the CPU
  (``python -m repro_torch.launch.serve ... --device cpu``).
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
    for name in ("kernels.bsr_spgemm.kernel", "core.session",
                 "kernels.cuda_lib", "kernels.flash_attention.kernel",
                 "kernels.flash_attention.ops", "kernels.moe_gemm.kernel",
                 "kernels.moe_gemm.ops", "configs.registry",
                 "configs.qwen2_moe", "models.layers", "models.attention",
                 "models.moe", "models.blocks", "models.transformer",
                 "models.convert", "serve.engine", "launch.serve"):
        assert f"repro_torch.{name}" in mods, name
    assert len(mods) >= 50


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
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg
    importlib.import_module("repro_torch")
    for name in _modules():
        importlib.import_module(name)
    assert kernel._lib is None and fa._lib is None and mg._lib is None


def test_serve_cli_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-moe-a2.7b", "--smoke", "--device", "cpu", "--max-new", "5"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("generated 20 tokens for 4 requests")
    assert lines[0].endswith("on cpu")
    rows = [ln for ln in lines if ln.startswith("req")]
    assert len(rows) == 4
    for row in rows:
        toks = ast.literal_eval(row.split("-> ")[1])
        assert len(toks) == 5 and all(0 <= t < 128 for t in toks)


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
