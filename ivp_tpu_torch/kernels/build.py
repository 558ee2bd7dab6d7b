"""Build the CUDA kernel libraries at first use and bind them with ctypes.

``nvcc`` compiles each ``csrc/<name>.cu`` (with the headers under ``csrc/``)
into a shared library of its own with a plain C interface, for Hopper
(``sm_90a``), into ``ivp_tpu_torch/_build/``: one library per method, built
when that method first launches, or all at once and in parallel by
:func:`build_all`.  A library's name carries a hash of its source, the
headers, the flags and the defines, so an edit rebuilds it and an unchanged
tree reuses it; nvcc's output (ptxas's registers and spills) is kept beside
it as ``.log``.  Another source tree or ``-D`` defines build another library
beside the default one (measure_kernel.py's A/B and occupancy sweep).
Nothing here runs at import time: a machine without nvcc or a GPU imports
this module and fails only when it asks for a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# No --use_fast_math: logf, expf, sqrtf and division keep their IEEE
# versions, which the float32 step controller needs to follow the reference.
# -fno-gnu-unique keeps each library's template statics its own: by default
# the dynamic linker merges them across every library loaded, so a second
# build of the same source (an A/B's baseline) would read the first one's
# "shared memory attribute set" flags (erk_common.cuh::allow_stage) and
# launch without setting its own.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xcompiler",
              "-fno-gnu-unique", "-Xptxas=-v")

# Flags of one source beside NVCC_FLAGS.  The stiff kernels are built
# without FMA contraction: each product and sum rounds once, as the plain
# version's tensor operations do, so their step sequences follow it lane for
# lane (csrc/stiff_common.cuh).
SOURCE_FLAGS = {name: ("-fmad=false",)
                for name in ("radau", "bdf", "radau_ev", "bdf_ev")}

# The source of the lean DOPRI5 kernel, and the default of every ``name``.
DOPRI5 = "dopri5_ensemble"

_libs: dict = {}
_entries: dict = {}


def _sources(src_dir: Path, name: str) -> list[Path]:
    """``<name>.cu`` and every header under ``src_dir``."""
    return [src_dir / f"{name}.cu"] + sorted(src_dir.rglob("*.cuh"))


def names(src_dir: Path = SRC_DIR) -> list[str]:
    """The libraries ``src_dir`` holds: one per ``*.cu``."""
    return sorted(p.stem for p in Path(src_dir).glob("*.cu"))


def flags_of(name: str, defines=()) -> tuple:
    """nvcc's flags for ``<name>.cu`` with ``-D`` ``defines``."""
    return (NVCC_FLAGS + SOURCE_FLAGS.get(name, ())
            + tuple(f"-D{d}" for d in defines))


def library_path(src_dir: Path = SRC_DIR, defines=(), name: str = DOPRI5) -> Path:
    flags = flags_of(name, defines)
    h = hashlib.sha256(" ".join(flags).encode())
    for p in _sources(Path(src_dir), name):
        h.update(str(p.relative_to(src_dir)).encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libivp_{name}_{h.hexdigest()[:16]}.so"


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


def build(src_dir: Path = SRC_DIR, defines=(), name: str = DOPRI5) -> Path:
    """Compile ``src_dir/<name>.cu`` with ``-D`` ``defines`` unless a build
    of these sources exists; return the library's path.  nvcc's output goes
    to the path with suffix ``.log``.  Raises RuntimeError with nvcc's
    output if nvcc fails.  Safe to call from several threads at once."""
    src_dir = Path(src_dir)
    out = library_path(src_dir, defines, name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *flags_of(name, defines), "-o", tmp,
               str(src_dir / f"{name}.cu")]
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


def build_all(src_dir: Path = SRC_DIR) -> dict:
    """Build every library of ``src_dir``, one nvcc each, all started
    together; ``{name: path}``."""
    todo = names(src_dir)
    with ThreadPoolExecutor(max_workers=len(todo)) as ex:
        futs = {n: ex.submit(build, src_dir, (), n) for n in todo}
        return {n: f.result() for n, f in futs.items()}


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its error-string entry."""
    lib = ctypes.CDLL(str(path))
    lib.ivp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ivp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library(name: str = DOPRI5) -> ctypes.CDLL:
    """The loaded library of the package's ``csrc/<name>.cu`` (built on
    first call)."""
    if name not in _libs:
        _libs[name] = load(build(name=name))
    return _libs[name]


def entry(name: str, argtypes: list, restype=ctypes.c_int, lib=None):
    """A C entry of ``lib`` (default: the lean DOPRI5 library) with its
    argument types declared.  NotImplementedError if the library has no
    such entry (a functor with no entry of that mode, as ``rhs.ball``
    without its event set)."""
    lib = library() if lib is None else lib
    fn = _entries.get((id(lib), name))
    if fn is None:
        try:
            fn = getattr(lib, name)
        except AttributeError:
            raise NotImplementedError(
                f"the kernel library has no entry {name}: this RHS, event "
                f"set and mode are not built for the card (ivp_tpu_torch/"
                f"rhs.py and events.py say which are); on the CPU it runs"
            ) from None
        fn.argtypes = argtypes
        fn.restype = restype
        _entries[(id(lib), name)] = fn
    return fn


def ptxas_report(path: Path) -> list:
    """``[(kernel, registers, spill store bytes, spill load bytes)]`` from
    the nvcc log beside a built library, the kernel as ptxas mangles it."""
    out, fn, spill = [], "?", (0, 0)
    for line in Path(path).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((fn, int(m.group(1)), *spill))
    return out


def check(err: int, what: str, lib=None) -> None:
    """Raise if a C entry of ``lib`` returned a CUDA error code."""
    if err != 0:
        lib = library() if lib is None else lib
        msg = lib.ivp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
