"""Build the CUDA kernel library at first use and bind it with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` (with the headers under ``csrc/``) into
one shared library with a plain C interface, for Hopper (``sm_90a``), into
``ivp_tpu_torch/_build/``.  The library's name carries a hash of the sources,
flags and defines, so an edit rebuilds it and an unchanged tree reuses it;
nvcc's output (ptxas's registers and spills) is kept beside it as ``.log``.
Another source tree or ``-D`` defines build another library beside the
default one (measure_kernel.py's A/B and occupancy sweep).  Nothing here
runs at import time: a machine without nvcc or a GPU imports this module and
fails only when it asks for the library.
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


def _sources(src_dir: Path) -> list[Path]:
    return sorted(p for p in src_dir.rglob("*") if p.suffix in (".cu", ".cuh"))


def library_path(src_dir: Path = SRC_DIR, defines=()) -> Path:
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    h = hashlib.sha256(" ".join(flags).encode())
    for p in _sources(src_dir):
        h.update(str(p.relative_to(src_dir)).encode())
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


def build(src_dir: Path = SRC_DIR, defines=()) -> Path:
    """Compile the library of ``src_dir`` with ``-D`` ``defines`` unless a
    build of these sources exists; return its path.  nvcc's output goes to
    the path with suffix ``.log``.  Raises RuntimeError with nvcc's output
    if nvcc fails.  Safe to call from several threads at once."""
    src_dir = Path(src_dir)
    out = library_path(src_dir, defines)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources(src_dir) if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp,
               *cu]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc={r.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its error-string entry."""
    lib = ctypes.CDLL(str(path))
    lib.ivp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ivp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library of the package's sources (built on first
    call)."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def entry(name: str, argtypes: list, restype=ctypes.c_int, lib=None):
    """A C entry of ``lib`` (default: :func:`library`) with its argument
    types declared."""
    lib = library() if lib is None else lib
    fn = _entries.get((id(lib), name))
    if fn is None:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
        _entries[(id(lib), name)] = fn
    return fn


def check(err: int, what: str, lib=None) -> None:
    """Raise if a C entry of ``lib`` returned a CUDA error code."""
    if err != 0:
        lib = library() if lib is None else lib
        msg = lib.ivp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
