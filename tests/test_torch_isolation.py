"""The PyTorch port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')"
        " and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA device the smoke script exits non-zero and prints no
    result line, here and in a directory that holds only the script."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, cwd=script.parent, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


DRY_RUN_MODULES = ("core/jaxpr_cost.py", "core/hlo.py", "launch/dryrun.py",
                   "benchmarks/roofline.py", "kernels/priced.py")


@pytest.mark.parametrize("rel", DRY_RUN_MODULES)
def test_dry_run_modules_stand_alone(rel):
    """The dry run's modules exist and import neither jax nor the JAX
    package."""
    path = PORT / rel
    assert path.exists(), rel
    assert not set(_imported_roots(path)) & {"jax", "jaxlib", "repro"}


def test_importing_the_dry_run_starts_no_process_group():
    """The fake mesh's process group is made only when a cell runs on it:
    importing the dry run, the roofline benchmark and the mesh module leaves
    torch.distributed uninitialized (and jax and the JAX package
    unimported)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch.distributed as dist\n"
        "import repro_torch.launch.dryrun, repro_torch.benchmarks.roofline\n"
        "import repro_torch.launch.mesh\n"
        "print(dist.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
