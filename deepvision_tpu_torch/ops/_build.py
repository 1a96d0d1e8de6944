"""Build the port's native sources and load them with ctypes.

Each ``csrc/<stem>.cu`` is compiled on first use by ``nvcc`` into a
shared library with a plain C interface, for ``sm_90a`` (linked against
the toolkit's libraries that :data:`LINK` names: ``nvjpeg`` for the JPEG
binding), and each host source ``csrc/<stem>.cpp`` (the CRC32C) by the
system C++ compiler, under ``build/kernels/`` at the root of the
checkout. The library's file name carries a hash of the source, of
every header under ``csrc/`` and of the flags, so an edited source or
shared header is rebuilt and an unchanged one is loaded as it is. There
is no fallback: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "CXX_FLAGS", "LINK", "BUILD_DIR", "CSRC",
           "find_nvcc", "find_cxx", "library_path", "build", "load_library"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
# toolkit libraries a CUDA source links against, by stem
LINK: dict[str, tuple[str, ...]] = {"nvjpeg": ("nvjpeg",)}

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


def find_cxx() -> str:
    """The system C++ compiler (``$CXX``, else ``g++`` or ``c++`` on
    PATH); raises when there is none."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no C++ compiler found ($CXX, g++, c++): the port's host sources "
        "(csrc/*.cpp) are built on first use and have no substitute")


def _source(stem: str) -> Path:
    for suffix in (".cu", ".cpp"):
        if (CSRC / f"{stem}{suffix}").is_file():
            return CSRC / f"{stem}{suffix}"
    raise FileNotFoundError(f"no csrc/{stem}.cu or csrc/{stem}.cpp")


def _command(src: Path, out: Path) -> list[str]:
    if src.suffix == ".cpp":
        return [find_cxx(), *CXX_FLAGS, "-o", str(out), str(src)]
    nvcc = find_nvcc()
    link = []
    for lib in LINK.get(src.stem, ()):
        # the toolkit's own copy, found again at load time by the rpath
        home = _toolkit_with(lib, nvcc)
        link += [f"-I{home / 'include'}", f"-L{home / 'lib64'}", f"-l{lib}",
                 "-Xlinker", f"-rpath={home / 'lib64'}"]
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src), *link]


def _toolkit_with(lib: str, nvcc: str) -> Path:
    """The CUDA toolkit directory that holds ``lib64/lib<lib>.so``: the
    one of ``nvcc``, else ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    homes = [Path(nvcc).resolve().parents[1],
             Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")]
    for home in homes:
        if (home / "lib64" / f"lib{lib}.so").exists():
            return home
    raise RuntimeError(f"lib{lib}.so not found under "
                       f"{[str(h / 'lib64') for h in homes]}")


def library_path(stem: str) -> Path:
    """Where the library of ``csrc/<stem>.cu`` (or ``.cpp``) is built:
    its name carries a hash of the source, of every header under
    ``csrc/`` (the sources share one) and of the flags."""
    src = _source(stem)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(p for p in CSRC.iterdir()
                         if p.suffix in (".cuh", ".h")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    flags = CXX_FLAGS if src.suffix == ".cpp" else NVCC_FLAGS
    h.update(" ".join((*flags, *LINK.get(stem, ()))).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build(stem: str) -> Path:
    """Compile ``csrc/<stem>.cu`` with ``nvcc`` (or ``csrc/<stem>.cpp``
    with the C++ compiler) unless a library of the same source, headers
    and flags exists; returns the library's path."""
    src = _source(stem)
    out = library_path(stem)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent builder of
    # the same source never sees a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = _command(src, tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed to build {src} (exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_logs[stem] = proc.stdout + proc.stderr
    return out


def load_library(stem: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<stem>.cu`` or ``.cpp``; one
    handle per process and stem."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build(stem)))
            _loaded[stem] = lib
        return lib
