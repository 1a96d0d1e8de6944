"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<stem>.cu`` is compiled on first use into a shared library
with a plain C interface, for ``sm_90a``, under ``build/kernels/`` at
the root of the checkout. The library's file name carries a hash of the
source, of every header under ``csrc/`` and of the flags, so an edited
source or shared header is rebuilt and an unchanged one is loaded as it
is. There is no fallback: a missing ``nvcc`` or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "CSRC", "find_nvcc", "library_path",
           "build", "load_library"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills) of each build made
# by this process, by stem: chip_smoke.py prints it
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    """The ``nvcc`` on PATH, else the one under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ on the machine with the "
        "card and have no substitute")


def library_path(stem: str) -> Path:
    """Where the library of ``csrc/<stem>.cu`` is built: its name carries
    a hash of the source, of every header under ``csrc/`` (the sources
    share one) and of the flags."""
    h = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(p for p in CSRC.iterdir()
                         if p.suffix in (".cuh", ".h")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build(stem: str) -> Path:
    """Compile ``csrc/<stem>.cu`` unless a library of the same source,
    headers and flags exists; returns the library's path."""
    src = CSRC / f"{stem}.cu"
    out = library_path(stem)
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent builder of
    # the same source never sees a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_logs[stem] = proc.stdout + proc.stderr
    return out


def load_library(stem: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<stem>.cu``; one handle per
    process and stem."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build(stem)))
            _loaded[stem] = lib
        return lib
