"""Build the package's CUDA sources at first use and load them.

``csrc/<stem>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface under ``build/repro_torch/`` at the root of the
checkout, named by a hash of the source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header
rebuilds and an unchanged one loads at once. The library is
loaded with ``ctypes``; callers declare ``argtypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build on a machine with the CUDA toolkit")


def _target(stem: str) -> Path:
    h = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build(stem: str) -> dict:
    """Compile ``csrc/<stem>.cu`` unless its library exists.

    Returns the build's seconds (0 when it was already built) and the
    compiler's report (``-Xptxas -v``: registers, shared memory and
    spills per kernel). Raises on a failed build.
    """
    out = _target(stem)
    if out.exists():
        return {"seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    p = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                        str(CSRC / f"{stem}.cu")],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed on {stem}.cu:\n{p.stdout}")
    os.replace(tmp, out)            # atomic: concurrent builders agree
    return {"seconds": time.perf_counter() - t0, "log": p.stdout}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built if needed."""
    if stem not in _loaded:
        build(stem)
        _loaded[stem] = ctypes.CDLL(str(_target(stem)))
    return _loaded[stem]
