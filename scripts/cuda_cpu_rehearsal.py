"""Rehearse the real-FFT and inverse kernels' CUDA sources on the CPU.

    python3 scripts/cuda_cpu_rehearsal.py [WL ...] [--sweep LO HI]
        [--every K --first I] [--threads 32]

Compiles ``zaftpu_torch/csrc/rfft.cu`` and ``irfft.cu`` with ``g++`` against
a small stand-in for the CUDA runtime (``HEADER`` below: each block's
threads run as ``std::thread``s with a ``std::barrier`` for
``__syncthreads``, blocks one after another, the ``__f*_rn`` intrinsics as
plain IEEE single operations under ``-ffp-contract=off``, shared memory
poisoned before each launch), then calls the C entries on CPU tensors
through ``ctypes`` and holds every output bit-equal to its plain PyTorch
version: the half, planes, full, magnitude and mel stores (magnitude and
power), the inverse on folded planes and the fused fold on a full spectrum
that is not Hermitian, frames-major and bins-major, at each window given
(or every window from LO to HI that ``rfft.fits`` refuses, every K-th from
the I-th), 3 to 9 frames, batched, at the hops ``WL // 3 + 1``, ``WL // 7
+ 1`` and ``WL``. A block runs on ``--threads`` threads (the kernels' loops stride by
``blockDim.x``, so the values are those of 256). It proves the kernels'
indexing and operation order, not that ``nvcc`` takes them or that they
are race-free on the card. The build goes to ``build/cpu_rehearsal/``
(one directory for each source hash).
Prints the first 20 mismatches and exits 1 if there is one.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from zaftpu_torch.kernels import _build, irfft, melfft, rfft  # noqa: E402

OUT = ROOT / "build" / "cpu_rehearsal"
HEADER = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <tuple>
#include <vector>

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local uint3 threadIdx;
inline uint3 blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_bar = nullptr;
inline void* emu_smem_ptr = nullptr;
inline int emu_threads = 256;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T min(T a, T b) { return a < b ? a : b; }
template <class T> inline T max(T a, T b) { return a < b ? b : a; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return 0; }
template <class K> inline int cudaFuncSetAttribute(K, int, int bytes) {
  return bytes > 232448 ? 1 : 0;  // an H100 block's most shared memory
}
inline const char* cudaGetErrorString(int) { return "cpu rehearsal"; }

template <class... P, class... A>
void emu_launch(void (*k)(P...), dim3 grid, int, size_t smem, cudaStream_t,
                A&&... args) {
  std::vector<double> shared(smem / sizeof(double) + 2);
  std::memset(shared.data(), 0xff, shared.size() * sizeof(double));
  emu_smem_ptr = shared.data();
  const int threads = emu_threads;
  gridDim = grid;
  blockDim = dim3(threads);
  std::tuple<std::decay_t<P>...> params(args...);
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = {bx, by, 0};
      std::barrier<> bar(threads);
      emu_bar = &bar;
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t) {
        ts.emplace_back([&, t] {
          threadIdx = {(unsigned)t, 0, 0};
          std::apply(k, params);
        });
      }
      for (auto& th : ts) th.join();
    }
  }
}
"""
EXTRA = """#include "common.cuh"
ZT_EXPORT void zt_rehearsal_threads(int n) { emu_threads = n; }
"""


def build() -> ctypes.CDLL:
    """The C entries of rfft.cu and irfft.cu compiled for the CPU, under a
    directory named by the sources' hash: built once for each version of
    the sources (a running rehearsal keeps its library while another
    builds)."""
    out = OUT / _build.source_hash()
    src = out / "src"
    (out / "inc").mkdir(parents=True, exist_ok=True)
    src.mkdir(exist_ok=True)
    (out / "inc" / "cuda_runtime.h").write_text(HEADER)
    for f in _build.CSRC.iterdir():
        text = f.read_text()
        text = re.sub(r"extern __shared__ __align__\(16\) float2 (\w+)\[\];",
                      r"float2* \1 = (float2*)emu_smem_ptr;", text)
        text = re.sub(r"extern __shared__ float (\w+)\[\];",
                      r"float* \1 = (float*)emu_smem_ptr;", text)
        text = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", text,
                      flags=re.S)
        (src / f.name).write_text(text)
    (src / "rehearsal.cu").write_text(EXTRA)
    lib = out / "librehearsal.so"
    if not lib.exists():
        tmp = out / f"librehearsal.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread", "-w", "-x", "c++", "-I", str(out / "inc"),
             "-I", str(src), "-o", str(tmp),
             *(str(src / n) for n in ("rfft.cu", "irfft.cu", "errors.cu",
                                      "rehearsal.cu"))], check=True)
        os.replace(tmp, lib)  # another rehearsal sees all of it or none
    loaded = ctypes.CDLL(str(lib))
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(loaded, name):
            getattr(loaded, name).argtypes = argtypes
            getattr(loaded, name).restype = ctypes.c_int
    return loaded


def _window(wl: int) -> torch.Tensor:
    n = np.arange(wl)
    return torch.from_numpy(
        (0.54 - 0.46 * np.cos(2 * np.pi * n / wl)).astype(np.float32))


def stores(lib, wl: int, step: int, t: int, batch: int = 2) -> list:
    """The five stores against their plain versions; the failures."""
    rng = np.random.default_rng(wl)
    n = (t - 1) * step + wl
    flat = torch.from_numpy(rng.standard_normal(batch * n + 1).astype(
        np.float32))
    padded = flat[1:].view(batch, n).contiguous()
    win, tw = _window(wl), rfft.kernel_tables(wl, "cpu")
    big, f = rfft.layout(wl).p, wl // 2 + 1
    ptrs = (padded.data_ptr(), win.data_ptr(), tw.data_ptr())
    args = (padded, win, wl, step, t)
    bad = []

    def run(entry, out):
        err = getattr(lib, entry)(*ptrs, out.data_ptr(), batch, n, t, wl,
                                  step, big, None)
        if err:
            bad.append(f"{entry} WL {wl}: error {err}")
        return out

    nan = float("nan")
    half = run("zt_rfft_half", torch.full((batch, t, f), nan,
                                          dtype=torch.complex64))
    planes = run("zt_rfft_planes", torch.full((2, batch, t, f), nan))
    full = run("zt_rfft_full", torch.full((batch, t, wl), nan,
                                          dtype=torch.complex64))
    spec = run("zt_rfft_spec", torch.full((batch, t, wl // 2), nan))
    ref = rfft.frames_rfft_fft_plain(*args)
    checks = [("half", half, ref),
              ("planes", torch.complex(planes[0], planes[1]), ref),
              ("full", full, rfft.frames_rfft_full_fft_plain(*args)),
              ("magnitude", spec, melfft.spec_rows_fft_plain(*args))]
    fb = rng.random((7, wl // 2))
    fb[rng.random(fb.shape) < 0.7] = 0
    table = melfft.device_table(melfft.filterbank_table(fb), "cpu")
    for power in (0, 1):
        mel = torch.full((batch, t, 7), nan)
        err = lib.zt_rfft_mel(
            *ptrs, table.rowptr.data_ptr(), table.cols.data_ptr(),
            table.weights.data_ptr(), mel.data_ptr(), batch, n, t, wl, step,
            big, 7, power, None)
        if err:
            bad.append(f"zt_rfft_mel WL {wl}: error {err}")
        checks.append((f"mel (power {power})", mel, melfft.mel_rows_fft_plain(
            padded, win, table, wl, step, t, bool(power))))
    bad += [f"{what} WL {wl} hop {step}" for what, got, want in checks
            if not torch.equal(got, want)]
    return bad


def inverse(lib, wl: int, step: int, t: int, batch: int) -> list:
    """The inverse on folded planes and the fused fold (frames-major and
    bins-major) against their plain versions; the failures."""
    rng = np.random.default_rng(wl + step)
    h = torch.from_numpy(rng.standard_normal(
        (2, batch, t, wl // 2 + 1)).astype(np.float32))
    z = torch.complex(*torch.from_numpy(rng.standard_normal(
        (2, batch, t, wl)).astype(np.float32)))
    tw, big = rfft.kernel_tables(wl, "cpu"), rfft.layout(wl).p
    out_len, scale = (t - 1) * step + wl, 0.7310586
    s = irfft._factor_c(wl, scale)
    bad = []
    out = torch.full((batch, out_len), float("nan"))
    err = lib.zt_irfft_ola(h[0].data_ptr(), h[1].data_ptr(), tw.data_ptr(),
                           out.data_ptr(), s, batch, t, wl, step, big, None)
    if err or not torch.equal(out, irfft.istft_ola_fft_plain(
            h[0], h[1], wl, step, scale)):
        bad.append(f"inverse WL {wl} hop {step} (error {err})")
    for layout in ("frames-major", "bins-major"):
        zz = z if layout == "frames-major" else (
            z.transpose(-1, -2).contiguous().transpose(-1, -2))
        out = torch.full((batch, out_len), float("nan"))
        err = lib.zt_irfft_ola_full(zz.data_ptr(), tw.data_ptr(),
                                    out.data_ptr(), s, batch, t, wl, step,
                                    big, *zz.stride(), None)
        if err or not torch.equal(out, irfft.istft_ola_fft_full_plain(
                zz, wl, step, scale)):
            bad.append(f"fused fold {layout} WL {wl} hop {step} "
                       f"(error {err})")
    return bad


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("windows", nargs="*", type=int)
    parser.add_argument("--sweep", nargs=2, type=int, metavar=("LO", "HI"))
    parser.add_argument("--every", type=int, default=1)
    parser.add_argument("--first", type=int, default=0)
    parser.add_argument("--threads", type=int, default=32)
    args = parser.parse_args()
    torch.set_num_threads(1)
    wins = list(args.windows)
    if args.sweep:
        lo, hi = args.sweep
        wins += [w for w in range(lo, hi + 1)
                 if not rfft.fits(w)][args.first::args.every]
    t0 = time.perf_counter()
    lib = build()
    lib.zt_rehearsal_threads(args.threads)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    bad = []
    for wl in wins:
        bad += stores(lib, wl, wl // 3 + 1, 3)
        for step, t, batch in ((wl // 3 + 1, 4, 2), (wl // 7 + 1, 9, 1),
                               (wl, 3, 3)):
            bad += inverse(lib, wl, step, t, batch)
    print(f"{len(wins)} windows in {time.perf_counter() - t0:.1f} s: "
          f"{len(bad)} mismatches")
    for line in bad[:20]:
        print(line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
