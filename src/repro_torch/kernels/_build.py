"""Build of the port's CUDA kernels: ``nvcc`` into shared libraries with a
plain C interface, loaded with :mod:`ctypes`.

Every ``csrc/*.cu`` is compiled on first use, all sources at once (one
``nvcc`` process each), into ``build/kernels/`` at the repository root.  A
library's file name carries a hash of its source, the shared headers and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is.  Nothing here runs at import time: a machine without ``nvcc``
(the CPU test machine) imports the kernel modules freely and only a launch
on a CUDA tensor reaches this code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH): the port's "
                           "CUDA kernels cannot be built on this machine")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    for f in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _build_all() -> None:
    """Compile every stale source in parallel; raise with nvcc's output if
    any fails.  The compiler's report (registers, spills, shared memory)
    is kept beside each library as ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc {src.name} (rc={proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def build() -> Dict[str, ctypes.CDLL]:
    """Build (if stale) and load every kernel library, keyed by source
    stem.  Idempotent and thread-safe."""
    with _lock:
        if not _libs:
            _build_all()
            for src in sorted(CSRC.glob("*.cu")):
                _libs[src.stem] = ctypes.CDLL(str(_target(src)))
    return _libs


@functools.lru_cache(maxsize=None)
def c_function(source: str, name: str,
               argtypes: Tuple) -> "ctypes._CFuncPtr":
    """The C entry point ``name`` of ``csrc/<source>.cu`` with its argument
    types declared.  Pointers and the stream go as ``c_void_p``: a bare
    Python int would be passed as a 32-bit int and cut."""
    fn = getattr(build()[source], name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(source: str, name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch shows up
    only through ``cudaGetLastError`` right after it)."""
    if err:
        lib = build()[source]
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


__all__ = ["BUILD_DIR", "build", "c_function", "check"]
