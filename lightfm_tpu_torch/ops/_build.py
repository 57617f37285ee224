"""Build the package's CUDA sources at first use and load them with ctypes.

Every ``lightfm_tpu_torch/csrc/*.cu`` compiles, with one ``nvcc`` process
per source started together, into its own shared library with a plain C
interface under ``lightfm_tpu_torch/_build/`` (listed in ``.gitignore``).
The library name carries a hash of the source, of every ``csrc/*.cuh``
header and of the flags, so an edited source or header rebuilds and an
unchanged one is reused.  Nothing here runs at
import time: the CPU-only test host has no ``nvcc``.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3``, and deliberately no
``--use_fast_math`` -- the rank kernels' exact ``>=`` tie semantics need
IEEE fp32 fused multiply-adds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from lightfm_tpu_torch import observability

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
            "toolkit is needed to build lightfm_tpu_torch's kernels"
        )
    return path


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source that has no current library, all in parallel,
    then load them all.  Returns ``{source stem: CDLL}``.  Raises with the
    compiler's output when a build fails."""
    with _LOCK:
        sources = sorted(CSRC.glob("*.cu"))
        todo = {s: _target(s) for s in sources if s.stem not in _LIBS}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        nvcc = None
        for src, out in todo.items():
            if out.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = out.with_suffix(".log")
            with open(log, "wb") as fh:
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=fh, stderr=subprocess.STDOUT,
                )
            procs.append((proc, tmp, out, log))
            observability.count(f"kernel_builds.{src.stem}")
        failed = []
        with observability.span("kernel.build"):
            for proc, tmp, out, log in procs:
                if proc.wait() == 0:
                    os.replace(tmp, out)  # atomic: concurrent builders agree
                else:
                    failed.append(f"{out.name}:\n{log.read_text(errors='replace')}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for src, out in todo.items():
            _LIBS[src.stem] = ctypes.CDLL(str(out))
        return dict(_LIBS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on demand)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for
    the current build of ``csrc/<name>.cu``, or "" when it was reused."""
    log = _target(CSRC / f"{name}.cu").with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""
