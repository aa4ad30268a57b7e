"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point.  It is
compiled with ``nvcc`` at first use, from the source in this package, into
``_build/<source hash>/`` beside it (``build.log`` there keeps ptxas'
registers and spills), and loaded with ctypes.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# -fmad=false: each kernel repeats its plain version's operations in their
# order, and without contracted multiply-adds its results carry the plain
# version's bits (see the notes at the top of the sources).
# -Xptxas=-v writes each kernel's registers and spills to build.log.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]


def find_nvcc() -> str:
    """``nvcc`` on PATH, then ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the"
        " port's CUDA kernels cannot be built"
    )


def _flags(defines, fmad: bool):
    """``NVCC_FLAGS`` with ``-D`` for each ``name=value`` of ``defines``;
    ``fmad`` lets a kernel that is held to a tolerance, not to its plain
    version's bits, contract its multiply-adds."""
    flags = [f for f in NVCC_FLAGS if not (fmad and f == "-fmad=false")]
    return flags + [f"-D{d}" for d in defines]


def _source_hash(source: str, flags) -> str:
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(source: str, defines=(), fmad: bool = False) -> str:
    """Compile ``source`` (a path under ``csrc/``) into a shared library if
    this source has not been built yet with these ``defines``
    (``"NAME=value"`` strings, for a source that is specialised at compile
    time); returns the library's path."""
    name = os.path.splitext(os.path.basename(source))[0]
    flags = _flags(defines, fmad)
    out_dir = os.path.join(BUILD_DIR, _source_hash(source, flags))
    lib_path = os.path.join(out_dir, f"libvmt_{name}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *flags, "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def entry_point(source: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``source``'s library, built if needed,
    with its ``argtypes`` set and an ``int`` (CUDA error) result.  Callers
    keep it: each call loads the library."""
    fn = getattr(ctypes.CDLL(build(source)), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
