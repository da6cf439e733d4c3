"""Rehearse the real-FFT, inverse, fast MDCT and spectral CQT kernels' CUDA
sources on the CPU.

    python3 scripts/cuda_cpu_rehearsal.py [WL ...] [--sweep LO HI]
        [--every K --first I] [--threads 32]
    python3 scripts/cuda_cpu_rehearsal.py --mdct [--every K --first I]
    python3 scripts/cuda_cpu_rehearsal.py --cqt

Compiles ``zaftpu_torch/csrc/rfft.cu``, ``irfft.cu``, ``mdct.cu`` and
``cqtfft.cu`` with
``g++`` against a small stand-in for the CUDA runtime (``HEADER`` below:
each block's threads run as ``std::thread``s with a ``std::barrier`` for
``__syncthreads``, blocks one after another, a cluster's blocks side by
side with a barrier of their own and each other's shared memory
(``cooperative_groups``' ``this_cluster``, ``cudaLaunchKernelEx``), the
``__f*_rn`` intrinsics as plain IEEE single operations under
``-ffp-contract=off``, shared memory poisoned before each launch), then
calls the C entries on CPU tensors through ``ctypes`` and holds every
output bit-equal to its plain PyTorch version: the half, planes, full,
magnitude and mel stores (magnitude and power), the inverse on folded
planes and the fused fold on a full spectrum that is not Hermitian,
frames-major and bins-major, at each window given (or every window from
LO to HI that ``rfft.fits`` refuses, every K-th from the I-th), 3 to 9
frames, batched, at the hops ``WL // 3 + 1``, ``WL // 7 + 1`` and ``WL``.
A block runs on ``--threads`` threads (the kernels' loops stride by
``blockDim.x``, so the values are those of 256). ``--mdct`` instead runs
the fast MDCT and IMDCT + overlap-add (``zt_mdct_fft``,
``zt_imdct_ola_fft``) against their plain versions: at
``chip_smoke.MDCT_FFT_RAGGED``'s shapes, at WL 32, 508, 572, 1,196, 2,048
and 4,096 (2 fpb + 1 frames, 2 rows, 1 or 3 floats past an aligned
address), T 1 and 2 at WL 2,048, and with ``--every K`` every K-th window
of ``mdct.fits`` from the I-th (``--every 1``: all 724). ``--cqt`` instead runs
the spectral CQT (``cqt_cases``: ``CqtConfig()``, L 2,048, dense and
conjugate foreign kernels, L 16, 32 and 128, at L 65,536 on two-block
clusters ``CQT_WIDE``, a batched misaligned case and a dense foreign
kernel, and at L 131,072 on four-block clusters a CQT from C0 at 44.1 kHz
and from A0 at 96 kHz, a batched misaligned case and a dense foreign
kernel) at the kernel's 1,024 threads a block. It proves the kernels'
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

from zaftpu_torch.core.windows import vorbis  # noqa: E402
from zaftpu_torch.kernels import (_build, cqtfft, irfft, melfft,  # noqa: E402
                                  rfft)
from zaftpu_torch.kernels import mdct as kmdct  # noqa: E402
from zaftpu_torch.transforms import cqt as tcqt  # noqa: E402

OUT = ROOT / "build" / "cpu_rehearsal"
HEADER = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <tuple>
#include <vector>

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
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
inline thread_local uint3 blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local std::barrier<>* emu_bar = nullptr;
inline thread_local void* emu_smem_ptr = nullptr;
inline int emu_threads = 256;
// A cluster's blocks run side by side: its barrier, each block's rank and
// the blocks' shared memory.
inline thread_local std::barrier<>* emu_cluster_bar = nullptr;
inline thread_local unsigned emu_cluster_rank = 0;
inline thread_local void** emu_cluster_smem = nullptr;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  std::memcpy(&x, &u, sizeof x);
  return x;
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T min(T a, T b) { return a < b ? a : b; }
template <class T> inline T max(T a, T b) { return a < b ? b : a; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return 0; }
template <class K> inline int cudaFuncSetAttribute(K, int, int bytes) {
  return bytes > 232448 ? 1 : 0;  // an H100 block's most shared memory
}
inline const char* cudaGetErrorString(int) { return "cpu rehearsal"; }

// Runs the grid cluster by cluster (cx blocks along x at once), each
// block's threads as std::threads with the block's barrier, shared memory
// poisoned.
template <class... P, class... A>
void emu_grid(void (*k)(P...), dim3 grid, unsigned cx, int threads,
              size_t smem, A&&... args) {
  gridDim = grid;
  blockDim = dim3(threads);
  std::tuple<std::decay_t<P>...> params(args...);
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; bx += cx) {
      std::vector<std::vector<double>> shared(
          cx, std::vector<double>(smem / sizeof(double) + 2));
      std::vector<void*> ptrs(cx);
      std::vector<std::unique_ptr<std::barrier<>>> bars;
      for (unsigned r = 0; r < cx; ++r) {
        std::memset(shared[r].data(), 0xff, shared[r].size() * sizeof(double));
        ptrs[r] = shared[r].data();
        bars.emplace_back(new std::barrier<>(threads));
      }
      std::barrier<> cbar(cx * threads);
      std::vector<std::thread> ts;
      for (unsigned r = 0; r < cx; ++r) {
        for (int t = 0; t < threads; ++t) {
          ts.emplace_back([&, r, t] {
            threadIdx = {(unsigned)t, 0, 0};
            blockIdx = {bx + r, by, 0};
            emu_bar = bars[r].get();
            emu_smem_ptr = ptrs[r];
            emu_cluster_bar = &cbar;
            emu_cluster_rank = r;
            emu_cluster_smem = ptrs.data();
            std::apply(k, params);
          });
        }
      }
      for (auto& th : ts) th.join();
    }
  }
}

template <class... P, class... A>
void emu_launch(void (*k)(P...), dim3 grid, int, size_t smem, cudaStream_t,
                A&&... args) {
  emu_grid(k, grid, 1, emu_threads, smem, std::forward<A>(args)...);
}

enum { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  int id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class K>
inline int cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t*) {
  *n = 66;
  return 0;
}
template <class... P, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*k)(P...),
                       A&&... args) {
  unsigned cx = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i) {
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      cx = cfg->attrs[i].val.clusterDim.x;
    }
  }
  if (cfg->gridDim.x % cx) return cudaErrorInvalidConfiguration;
  emu_grid(k, cfg->gridDim, cx, cfg->blockDim.x, cfg->dynamicSmemBytes,
           std::forward<A>(args)...);
  return 0;
}
"""
COOPERATIVE_GROUPS = r"""
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu_cluster_bar->arrive_and_wait(); }
  unsigned block_rank() const { return emu_cluster_rank; }
  template <class T>
  T* map_shared_rank(T* p, unsigned r) const {
    return (T*)((char*)emu_cluster_smem[r] +
                ((char*)p - (char*)emu_cluster_smem[emu_cluster_rank]));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
"""
EXTRA = """#include "common.cuh"
ZT_EXPORT void zt_rehearsal_threads(int n) { emu_threads = n; }
"""


def build() -> ctypes.CDLL:
    """The C entries of rfft.cu, irfft.cu, mdct.cu and cqtfft.cu compiled
    for the CPU, under a
    directory named by the sources' hash: built once for each version of
    the sources (a running rehearsal keeps its library while another
    builds)."""
    out = OUT / _build.source_hash()
    src = out / "src"
    (out / "inc").mkdir(parents=True, exist_ok=True)
    src.mkdir(exist_ok=True)
    (out / "inc" / "cuda_runtime.h").write_text(HEADER)
    (out / "inc" / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS)
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
             *(str(src / n) for n in ("rfft.cu", "irfft.cu", "mdct.cu",
                                      "cqtfft.cu", "errors.cu",
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


# The spectral CQT's rehearsal cases: (name, kernel's dense (F, L) array,
# hop, T, batch rows, signal offset in floats).
def cqt_cases() -> list:
    rng = np.random.default_rng(7)

    def dense(f, length, zeros):
        k = (rng.standard_normal((f, length))
             + 1j * rng.standard_normal((f, length))) / length
        k[rng.random(k.shape) < zeros] = 0
        return k

    high = tcqt.cqtkernel(8000, 12, 110.0, 880.0).kernel.copy()
    high[::2] = np.roll(high[::2, ::-1], 1, axis=1)
    return [
        ("CqtConfig() L 32,768", tcqt.cqtkernel(44100, 24, 55.0,
                                                3520.0).kernel, 1764, 3, 1,
         0),
        ("L 2,048 misaligned", tcqt.cqtkernel(8000, 12, 110.0,
                                              880.0).kernel, 320, 5, 2, 1),
        ("dense foreign L 512", dense(10, 512, 0.4), 160, 4, 2, 1),
        ("bands above L/2, L 2,048", high, 320, 3, 1, 0),
        ("dense foreign L 16", dense(3, 16, 0.3), 5, 7, 1, 0),
        ("dense foreign L 32", dense(4, 32, 0.3), 7, 9, 2, 1),
        ("dense foreign L 128", dense(5, 128, 0.3), 40, 6, 1, 0),
        ("CQT_WIDE L 65,536", tcqt.cqtkernel(44100, 24, 27.5,
                                             3520.0).kernel, 1764, 2, 1, 0),
        ("L 65,536 batched misaligned", tcqt.cqtkernel(8000, 12, 3.0,
                                                       12.0).kernel, 320, 2,
         2, 3),
        ("dense foreign L 65,536", dense(3, 65536, 0.5), 1000, 2, 1, 0),
        ("C0 44.1 kHz L 131,072", tcqt.cqtkernel(44100, 24, 16.35,
                                                 3520.0).kernel, 1764, 2, 1,
         0),
        ("A0 96 kHz L 131,072", tcqt.cqtkernel(96000, 24, 27.5,
                                               3520.0).kernel, 3840, 2, 1, 0),
        ("L 131,072 batched misaligned", tcqt.cqtkernel(8000, 12, 1.5,
                                                        6.0).kernel, 320, 2,
         2, 3),
        ("dense foreign L 131,072", dense(3, 131072, 0.5), 1000, 2, 1, 0),
    ]


def cqt(lib, name, dense, step, t, batch, offset) -> list:
    """The spectral CQT kernel against its plain version; the failures."""
    length = dense.shape[1]
    n = (t - 1) * step + length
    rng = np.random.default_rng(length + t)
    flat = torch.from_numpy(rng.standard_normal(batch * n + offset).astype(
        np.float32))
    sig = flat[offset:].view(batch, n)
    tab = cqtfft.device_table(cqtfft.kernel_table(dense), "cpu")
    tw = cqtfft.twiddles(length, torch.float32, "cpu")
    out = torch.full((batch, t, dense.shape[0]), float("nan"))
    err = lib.zt_cqt_magnitudes_fft(
        sig.data_ptr(), tw.data_ptr(), tab.rowptr.data_ptr(),
        tab.index.data_ptr(), tab.values.data_ptr(), tab.splits.data_ptr(),
        out.data_ptr(), batch, n, t, length, step, dense.shape[0],
        tab.splits.numel(), *tab.rsplit, None)
    ref = cqtfft.cqt_magnitudes_fft_plain(sig, tab, step, length, t)
    if err or not torch.equal(out, ref):
        bad = int((out != ref).sum())
        return [f"cqt {name}: error {err}, {bad} values "
                "differ"]
    return []


def mdct_cases(every, first) -> list:
    """The fast MDCT's rehearsal cases: (WL, T, batch rows, signal offset
    in floats)."""
    import chip_smoke

    def frames(wl):  # two blocks of the forward and one frame more
        return 2 * (2048 // (wl // 4)) + 1

    cases = list(chip_smoke.MDCT_FFT_RAGGED)
    cases += [(wl, frames(wl), 2, 1 + 2 * (i % 2))
              for i, wl in enumerate((32, 508, 572, 1196, 2048, 4096))]
    cases += [(2048, 1, 1, 0), (2048, 2, 2, 3)]
    if every:
        wins = [w for w in range(32, 4097, 4) if kmdct.fits(w)]
        cases += [(wl, frames(wl), 2, 1) for wl in wins[first::every]]
    return cases


def mdct(lib, wl: int, t: int, batch: int, offset: int) -> list:
    """The fast MDCT and IMDCT + overlap-add against their plain versions,
    the signal and the coefficients ``offset`` floats past an aligned
    address; the failures."""
    f = wl // 2
    n = (t + 1) * f
    rng = np.random.default_rng(wl + t + offset)
    flat = torch.from_numpy(rng.standard_normal(batch * n + offset).astype(
        np.float32))
    padded = flat[offset:].view(batch, n)
    win = torch.from_numpy(vorbis(wl).astype(np.float32))
    tw = kmdct.twiddles(wl, torch.float32, "cpu")
    tab = rfft.kernel_tables(f, "cpu")
    bad = []
    out = torch.full((batch, t, f), float("nan"))
    err = lib.zt_mdct_fft(padded.data_ptr(), win.data_ptr(), tw.data_ptr(),
                          tab.data_ptr(), out.data_ptr(), batch, n, t, wl,
                          None)
    ref = kmdct.mdct_fft_plain(padded, win, wl, t)
    if err or not torch.equal(out, ref):
        bad.append(f"mdct WL {wl} T {t} rows {batch} offset {offset}: "
                   f"error {err}, {int((out != ref).sum())} values differ")
    cflat = torch.zeros(ref.numel() + offset)
    cflat[offset:] = ref.reshape(-1)
    coeffs = cflat[offset:].view(batch, t, f)
    wb = vorbis(wl).tobytes()
    rec = torch.full((batch, n), float("nan"))
    err = lib.zt_imdct_ola_fft(
        coeffs.data_ptr(),
        kmdct.synthesis_window(wb, torch.float32, "cpu").data_ptr(),
        tw.data_ptr(), tab.data_ptr(), rec.data_ptr(), batch, t, wl, None)
    ref = kmdct.imdct_ola_fft_plain(coeffs, f, wb)
    if err or not torch.equal(rec, ref):
        bad.append(f"imdct WL {wl} T {t} rows {batch} offset {offset}: "
                   f"error {err}, {int((rec != ref).sum())} values differ")
    return bad


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("windows", nargs="*", type=int)
    parser.add_argument("--sweep", nargs=2, type=int, metavar=("LO", "HI"))
    parser.add_argument("--every", type=int)
    parser.add_argument("--first", type=int, default=0)
    parser.add_argument("--threads", type=int, default=32)
    parser.add_argument("--mdct", action="store_true",
                        help="the fast MDCT and IMDCT kernels' cases "
                        "instead")
    parser.add_argument("--cqt", action="store_true",
                        help="the spectral CQT kernel's cases instead "
                        "(1,024 threads a block, clusters of two and four)")
    args = parser.parse_args()
    torch.set_num_threads(1)
    wins = list(args.windows)
    if args.sweep:
        lo, hi = args.sweep
        wins += [w for w in range(lo, hi + 1)
                 if not rfft.fits(w)][args.first::args.every or 1]
    t0 = time.perf_counter()
    lib = build()
    lib.zt_rehearsal_threads(args.threads)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    bad = []
    if args.cqt:
        lib.zt_rehearsal_threads(1024)  # the kernel's kThreadsFft
        cases = cqt_cases()
        for case in cases:
            bad += cqt(lib, *case)
            print(f"{case[0]}: {time.perf_counter() - t0:.1f} s", flush=True)
    mcases = mdct_cases(args.every, args.first) if args.mdct else []
    for case in mcases:
        bad += mdct(lib, *case)
    if mcases:
        print(f"{len(mcases)} MDCT cases: {time.perf_counter() - t0:.1f} s",
              flush=True)
    for wl in wins:
        bad += stores(lib, wl, wl // 3 + 1, 3)
        for step, t, batch in ((wl // 3 + 1, 4, 2), (wl // 7 + 1, 9, 1),
                               (wl, 3, 3)):
            bad += inverse(lib, wl, step, t, batch)
    print(f"{len(wins)} windows{' and the CQT cases' if args.cqt else ''} in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{len(bad)} mismatches")
    for line in bad[:20]:
        print(line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
