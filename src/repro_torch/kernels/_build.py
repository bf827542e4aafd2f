"""Build and load the hand-written CUDA kernels (no counterpart in ``repro``).

Every ``csrc/*.cu`` file has a plain C interface and is compiled on its own by
``nvcc`` into a shared library, loaded with :mod:`ctypes` (no PyTorch headers,
so a build takes seconds rather than minutes).  The first call to
:func:`library` starts one ``nvcc`` per source, all at once, waits for them
and loads the results; later calls reuse the loaded libraries.  Outputs go
to ``build/torch_kernels/`` at the root of the checkout, named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
unchanged source is not rebuilt.

Nothing here runs at import time: a CPU-only machine imports the package
without ``nvcc``, and only a launch on a CUDA tensor reaches the build.
A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "SOURCES", "build_all", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
# The six kernels, the wide least-squares BCD kernel beside ``bcd_epoch``,
# and ``noop``: an empty kernel that ``chip_smoke.py`` launches to read the
# card's floor for one launch.
SOURCES = ("corr", "dual_norm", "bcd_epoch", "screening_scores",
           "bcd_epoch_logistic", "sgl_prox", "bcd_wide", "noop")
# src/repro_torch/kernels/_build.py -> the checkout root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _target(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name, nvcc) for name in SOURCES}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel source ``name`` (built on first
    use, together with every other source)."""
    with _LOCK:
        if not _LIBS:
            for src, path in build_all().items():
                _LIBS[src] = ctypes.CDLL(str(path))
        return _LIBS[name]
