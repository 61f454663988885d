"""Build and load the port's CUDA sources: ``nvcc`` for sm_90a into a
shared library with a plain C interface, loaded with ctypes.

A source compiles at first use into ``build/kernels/`` at the root of the
checkout, under a name keyed by a hash of the source and the flags, so an
edited source builds anew and an unchanged one loads what is there.
Nothing here runs at import: the CPU tests import the kernel modules on
machines with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: Path) -> Path:
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{key.hexdigest()[:16]}.so"


def build(source: Path) -> tuple[Path, float, str]:
    """Compile ``source`` unless its library exists.  Returns the path,
    the seconds the build took (0.0 when it was already built) and what
    the compiler printed (``-Xptxas -v``: registers, shared memory,
    spills)."""
    out = library_path(source)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.monotonic()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: no process loads a half-written file
    return out, time.monotonic() - t0, proc.stderr


def load(source: Path) -> ctypes.CDLL:
    """The library built from ``source``, built first if need be and
    loaded once per process."""
    with _lock:
        path = build(source)[0]
        lib = _loaded.get(path)
        if lib is None:
            lib = _loaded[path] = ctypes.CDLL(str(path))
        return lib
