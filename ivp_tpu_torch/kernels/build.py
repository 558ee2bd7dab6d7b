"""Build the CUDA kernel library at first use and bind it with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` (with the headers under ``csrc/``) into
one shared library with a plain C interface, for Hopper (``sm_90a``), into
``ivp_tpu_torch/_build/``.  The library's name carries a hash of the sources
and flags, so an edit rebuilds it and an unchanged tree reuses it.  Nothing
here runs at import time: a machine without nvcc or a GPU imports this module
and fails only when it asks for the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# No --use_fast_math: logf, expf, sqrtf and division keep their IEEE
# versions, which the float32 step controller needs to follow the reference.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None
_entries: dict = {}
build_log = ""   # nvcc's output of the build this process ran ("" if none)


def _sources() -> list[Path]:
    return sorted(p for p in SRC_DIR.rglob("*") if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(str(p.relative_to(SRC_DIR)).encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libivp_tpu_torch_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the library unless a build of these sources exists; return
    its path.  Raises RuntimeError with nvcc's output if nvcc fails."""
    global build_log
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
        r = subprocess.run(cmd, capture_output=True, text=True)
        build_log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc={r.returncode}):\n"
                               f"{' '.join(cmd)}\n{build_log}")
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.ivp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ivp_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def entry(name: str, argtypes: list, restype=ctypes.c_int):
    """A C entry of the library with its argument types declared."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _entries[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        msg = library().ivp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
