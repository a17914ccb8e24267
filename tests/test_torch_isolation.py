"""The port stands alone: importing ``repro_torch`` and every submodule
loads neither JAX nor any module of the ``repro`` package, and no source
file of the port, nor ``chip_smoke.py`` (which drives the port on the
card), imports them."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"


def port_modules():
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        parts = f.relative_to(SRC).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    return mods


def test_importing_the_port_loads_no_jax_and_no_reference_module():
    code = (
        "import importlib, sys\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert len(port_modules()) >= 15


def test_no_port_source_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)"
                     r"|from\s+(jax|repro)(\.|\s)(?!_torch))", re.M)
    offenders = [str(f.relative_to(SRC)) for f in PORT.rglob("*.py")
                 if pat.search(f.read_text())]
    assert offenders == []
    assert pat.search("from repro.core import x")
    assert pat.search("import jax.numpy as jnp")
    assert not pat.search("from repro_torch.core import x")


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)"
                     r"|from\s+(jax|repro)(\.|\s)(?!_torch))", re.M)
    src = (ROOT / "chip_smoke.py").read_text()
    assert "repro_torch" in src
    assert not pat.search(src)
    # importing it (its imports of the port run inside main) loads none
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
