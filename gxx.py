"""Build the CUDA sources with g++ as host code, to rehearse a kernel change
on CPU tensors before the card sees it.

    python gxx.py SRC_DIR OUT_DIR [name,...]

Each ``SRC_DIR/<name>.cu`` is compiled, behind a stand-in
``cuda_runtime.h`` (:data:`SHIM`), into ``OUT_DIR/lib<name>.so`` with the C
entries of the nvcc build.  A launch runs the grid's threads one after
another on the host, so a library is called on CPU tensors with stream 0
(``resumable.CardSolve``, ``stiff_ensemble.stiff_ensemble_cuda``,
``erk_ensemble.ensemble_launch``, ``erk_record.record_launches``;
``measure_kernel.py --phases rehearse``).
Before compiling, a copy of the sources is rewritten: each ``<<<...>>>``
launch becomes a loop over the grid (its dynamic shared memory's bytes in
``ivp_dynamic_smem``), the two ``min.NaN``/``max.NaN``
``asm`` lines plain C, and the extern dynamic shared arrays the shim's
static ones (threads run one at a time, each in its own slots).  PTX that
only nvcc takes sits under ``__CUDA_ARCH__``; the warp vote is one lane's
own (``__any_sync(m, p)`` is ``p``), ``__trap`` aborts.  Built with
``-ffp-contract=off`` and the host's libm, a g++ build follows another g++
build, not the card: two of them (a change and its parent) held field by
field find every logic fault of a change, and only the card's A/B proves
its bits.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SHIM = r"""// A stand-in for the CUDA runtime: csrc/*.cu as host code.
#pragma once
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <atomic>
#include <cmath>
#include <cstring>
#include <type_traits>
using std::isfinite;
using std::isnan;
#define __device__
#define __host__
#define __global__
#define __constant__
#define __shared__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct ivp_dim3 { unsigned x = 0, y = 0, z = 0; };
inline ivp_dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
struct cudaFuncAttributes { int numRegs = 0; size_t localSizeBytes = 0; };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "g++ build"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  *a = cudaFuncAttributes{};
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, K, int,
                                                          size_t) {
  *b = 1;
  return cudaSuccess;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline double __fma_rn(double a, double b, double c) { return fma(a, b, c); }
inline unsigned __float_as_uint(float x) {
  unsigned u;
  memcpy(&u, &x, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  memcpy(&x, &u, 4);
  return x;
}
inline int __double2hiint(double x) {
  long long u;
  memcpy(&u, &x, 8);
  return (int)(u >> 32);
}
inline int __double2loint(double x) {
  long long u;
  memcpy(&u, &x, 8);
  return (int)u;
}
inline double __hiloint2double(int hi, int lo) {
  const long long u = (long long)((unsigned long long)(unsigned)hi << 32 |
                                  (unsigned)lo);
  double x;
  memcpy(&x, &u, 8);
  return x;
}
inline unsigned __activemask() { return 0xffffffffu; }
inline bool __any_sync(unsigned, bool p) { return p; }
inline void __trap() { abort(); }
inline unsigned ivp_dynamic_smem;  // the launch's dynamic shared memory
template <class Fn>
void ivp_grid(long grid, long block, long smem, Fn fn) {
  ivp_dynamic_smem = (unsigned)smem;
  blockDim.x = (unsigned)block;
  gridDim.x = (unsigned)grid;
  for (long b = 0; b < grid; ++b)
    for (long t = 0; t < block; ++t) {
      blockIdx.x = (unsigned)b;
      threadIdx.x = (unsigned)t;
      fn();
    }
}
namespace ivp {
alignas(16) inline double ivp_rec_smem[1 << 16];
alignas(16) inline double ivp_stiff_smem[1 << 16];
}
"""

FLAGS = ("-std=c++20", "-O1", "-fPIC", "-shared", "-ffp-contract=off",
         "-fno-gnu-unique", "-w", "-x", "c++")

_LAUNCH = re.compile(
    r"([A-Za-z_][\w:]*(?:<[^;{}()]*?>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", re.S)
_MINMAX = re.compile(r'asm\("(max|min)\.NaN\.f32 %0, %1, %2;" : "=f"\(r\) '
                     r': "f"\(a\), "f"\(b\)\);')


def _top_level(s: str) -> list:
    """``s`` split at its commas outside brackets."""
    parts, depth, cur = [], 0, ""
    for ch in s:
        depth += (ch in "([{") - (ch in ")]}")
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def host_source(text: str) -> str:
    """A source's text as g++ compiles it behind :data:`SHIM`."""
    def launch(m):
        grid, block, *rest = _top_level(m.group(2))
        smem = rest[0] if rest else "0"
        return (f"ivp_grid(({grid}), ({block}), ({smem}), [&]() {{ "
                f"{m.group(1)}({m.group(3)}); }});")

    def minmax(m):
        op = ">" if m.group(1) == "max" else "<"
        return f"r = (a != a || b != b) ? NAN : (a {op} b ? a : b);"
    text = _MINMAX.sub(minmax, text)
    text = re.sub(r"extern __shared__ __align__\(16\) double (ivp_\w+_smem)"
                  r"\[\];", r"// \1: the shim's", text)
    return _LAUNCH.sub(launch, text)


def build_all(src_dir, out_dir, names=None) -> dict:
    """Compile ``names`` (default every ``.cu``) of ``src_dir`` into
    ``out_dir``, in parallel; ``{name: library path}``.  Raises with g++'s
    output if one fails."""
    src_dir, out_dir = Path(src_dir), Path(out_dir)
    tree = out_dir / "src"
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(src_dir, tree)
    for p in list(tree.rglob("*.cu")) + list(tree.rglob("*.cuh")):
        p.write_text(host_source(p.read_text()))
    (out_dir / "shim").mkdir(parents=True, exist_ok=True)
    (out_dir / "shim" / "cuda_runtime.h").write_text(SHIM)
    names = names or sorted(p.stem for p in tree.glob("*.cu"))

    def one(name):
        lib = out_dir / f"lib{name}.so"
        r = subprocess.run(["g++", *FLAGS, "-I", str(out_dir / "shim"),
                            "-I", str(tree), str(tree / f"{name}.cu"), "-o",
                            str(lib)], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"g++ {name}.cu failed:\n{r.stderr[-4000:]}")
        return name, lib
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        return dict(ex.map(one, names))


if __name__ == "__main__":
    print(build_all(sys.argv[1], sys.argv[2],
                    sys.argv[3].split(",") if len(sys.argv) > 3 else None))
