"""Drive the zaftpu_torch STFT -> ISTFT, MDCT -> IMDCT, spectrogram / mel /
MFCC and CQT paths once on an NVIDIA GPU, under the exact dial and under
ZAFTPU_PRECISION=split4, and the CQT under both of its schemes.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a) and ``nvcc``. Phases, in order; any failure stops the run with a
non-zero exit and no result line:

1. device: the card's name and power limit (as nvidia-smi gives them),
   torch and CUDA versions; TF32 off for matmuls and cuDNN;
2. build: the twenty-three kernels from zaftpu_torch/csrc (one nvcc per
   source, all started together), with the seconds taken;
3. kernels: each kernel against its plain PyTorch version on the card at
   its main-path shape (WL 2048, hop 1024, a 600-s segment: T = 25,841;
   F = 1,024 for the IMDCT; 40 mels; the CQT at CqtConfig(): T = 15,000,
   L = 32,768, hop 1764, F = 144) and a ragged one (WL 512, hop 128,
   T = 1,001 for the STFT, mirror and fold kernels and B12; WL 512 / hop
   256 for frames_op; F = 100 for imdct_ola; WL 512 / hop 128 with 20 mels
   for spec_rows and mel_rows; the CQT at 22,050 Hz, 12 bins per octave,
   110-3,520 Hz: L 4,096, hop 882, F 60, T 1,001), the split4 twins of B1,
   B2, B3, B4, B7, B9, B10 and B12 included. The real-FFT kernel (B1 and
   B12 at power-of-two windows, both stores) also at a batched, misaligned
   shape whose hop does not divide WL (3 rows, WL 512, hop 100, T 1,001).
   The GEMM B1 and B12 take their main-path shape from the 40-ms window
   the FFT rule leaves to them (WL 1,764, hop 882, a 600-s segment: T =
   30,001, no operator), a ragged one at WL 1,764 / hop 441, and WL 2048
   and WL 512 with their operator given (which names the GEMM); the mel
   kernels also past the old shared-memory limit (800 mels at WL 2048). Framing, OLA, mirror and fold must be bit-equal, the FFT
   kernel within 1e-6 * max|ref| (it does its plain version's operations
   in its order), the GEMM kernels within 2e-5 * max|ref|, and the kernels
   that only store another's sums elsewhere (B3, B12, their twins and the
   FFT's planes store) bit-equal to it (with the mirror); median times of
   kernel and plain version at the main-path shape (CUDA events), and of
   one PyTorch call computing the same function where there is one
   (torch.stft for B1, B3, B12, their twins and the FFT kernel, fold for
   the OLA, torch.istft of a ones window times WL / hop / gain for B4 and
   its twin, held against B4 away from the first and last WL samples);
   each kernel's bound, the least time the card could take, from its
   inputs;
4. STFT main path, default dispatch: stft -> istft of a 600-s signal with
   the periodic Hamming window; the spectrum against a float64 torch.fft
   oracle (<= 1e-5 * max|oracle|), the round-trip SNR (>= 120 dB), and
   launch counts showing the FFT analysis and the fused synthesis kernel
   ran and no plain version did; then the same with a 40-ms window (WL
   1,764, hop 882), which the shape rule sends to the GEMM B1, and under
   ZAFTPU_FUSED2=1 to the GEMM B12;
5. STFT main path, split dispatch (ZAFTPU_FUSED=0 ZAFTPU_SYNTH=0): the
   same checks, with the framing and OLA kernels;
6. MDCT main path: mdct -> imdct of the 600-s signal with vorbis(2048),
   under the default and the split dispatch; the coefficients against a
   float64 torch.fft MDCT oracle (<= 1e-5 * max|oracle|), the round-trip
   SNR (>= 120 dB), and launch counts (frames_op and imdct_ola, or framing
   and OLA; no plain version);
7. mel main path at MelConfig() (44.1 kHz, Hamming 2048 / hop 1024, 40
   mels, 20 coefficients): spectrogram, melspectrogram and mfcc of the
   600-s signal against float64 torch.fft oracles (<= 1e-5 * max|oracle|;
   MFCC atol 5e-3), under the default dispatch (at WL 2048 the real-FFT
   analysis kernel's half spectrum, by the shape rule) and ZAFTPU_MELFUSE=1
   (spec_rows and mel_rows, not the STFT's analysis kernel);
8. CQT main path at CqtConfig() (44.1 kHz, 24 bins per octave, 55-3,520
   Hz, 25 frames/s): cqtspectrogram and cqtchromagram of the 600-s signal
   against a float64 oracle on the card (per-frame FFT times the kernel's
   non-zero columns, then abs, zaf.py:627-633), under the default scheme
   (the split4 twin, <= 1e-4 * max|oracle|) and under
   ZAFTPU_PRECISION=highest and ZAFTPU_CQT_SCHEME=exact (the exact kernel,
   <= 1e-5 * max|oracle|), with launch counts showing which kernel ran and
   that no plain version did;
9. split4 main path (ZAFTPU_PRECISION=split4): stft -> istft and mdct ->
   imdct of the 600-s signal; the spectrum and the coefficients within
   1e-4 * max of the float64 oracles, the round trips in [100, 125) dB,
   and launch counts showing the split4 twins ran and no exact kernel or
   plain version did; then the mel phase under split4 with
   ZAFTPU_MELFUSE=1: melspectrogram and mfcc through the mel kernel's twin
   (within 1e-4 * max; MFCC atol 5e-3), spectrogram through the exact
   spec_rows (1e-5 * max);
10. levers: stft -> istft of the 600-s signal under ZAFTPU_MIRROR=pallas
   (fused_fft, mirror_full_planes, fold_half_planes, synth),
   ZAFTPU_FULLSPEC=1 (frames_rfft_full, synth) and ZAFTPU_FUSED2=1
   (frames_matmul2_fft, synth), then under split4 with ZAFTPU_FUSED2=1
   (frames_matmul2_split4, synth_split4) and ZAFTPU_FULLSPEC=1
   (frames_rfft_full_split4, synth_split4): spectrum and round trip
   bit-equal to those of the same dial without the lever where both share
   a tile (all but the exact-dial ZAFTPU_FULLSPEC=1, whose GEMM B3 stands
   beside the default FFT kernel), and that dial's oracle and SNR gates;
11. one hour: six 600-s segments through stft, then istft; mdct, then
   imdct; spectrogram; melspectrogram; mfcc, under the default, the split
   and the split4 dispatch, and the three mel front ends under
   ZAFTPU_MELFUSE=1 and under split4 with ZAFTPU_MELFUSE=1;
   cqtspectrogram and cqtchromagram (90,000 frames) under the default
   (split4) and the exact CQT scheme; frames/s from CUDA events (printed,
   not gated).

The CQT kernel is built on the host without the disk cache
(ZAFTPU_CACHE=0), so the run writes nothing outside the checkout.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import zaftpu_torch
from zaftpu_torch import CqtConfig, MelConfig
from zaftpu_torch.core import fft, policy
from zaftpu_torch.core.frame import stft_padding
from zaftpu_torch.core.windows import hamming, vorbis
from zaftpu_torch.features.mel import dct_ii_ortho_matrix, melfilterbank
from zaftpu_torch.kernels import (_build, cqtslab, framing, fused, melfused,
                                  mirror, ola, rfft, synth)
from zaftpu_torch.transforms import cqt as tcqt
from zaftpu_torch.transforms import mdct as tmdct

SR = 44100
SEGMENT_SECONDS = 600
SEGMENTS_PER_HOUR = 6
WL, STEP = 2048, 1024
RAGGED = (512, 128, 1001)  # WL, hop, T
MDCT_RAGGED = (512, 256, 1001)  # frames_op: WL, hop, T
IMDCT_RAGGED_F = 100  # imdct_ola: F, 16-row padding of the contraction
MEL_RAGGED = (512, 128, 1001, 20)  # spec_rows / mel_rows: WL, hop, T, mels
MEL_WIDE = (WL, STEP, 1001, 800)  # past the old shared-memory limit (745)
# The FFT kernel: WL, hop (not dividing WL), T, batch rows, sample offset.
FFT_RAGGED = (512, 100, 1001, 3, 1)
# A window the FFT rule leaves to the GEMM B1 / B12 (40 ms at 44.1 kHz).
GEMM_WL = 1764
GEMM_RAGGED = (GEMM_WL, 441, 1001)
GEMM_KERNELS = ("fused", "frames_matmul2")  # the GEMM B1 and B12
CQT_RAGGED = (CqtConfig(sampling_frequency=22050, octave_resolution=12,
                        minimum_frequency=110.0), 1001)  # L 4096, hop 882
SEED = 20260816
EXACT_TOL = 0.0
GEMM_TOL = 2e-5     # x max|ref|; TF32 would read about 1e-3
FFT_TOL = 1e-6      # x max|ref|; the FFT kernel does its plain version's ops
ORACLE_TOL = 1e-5   # x max|oracle|
MIN_SNR_DB = 120.0
MFCC_ATOL = 5e-3    # float32 against float64, tests/test_mel.py:70
# split4 (about 104 dB against float64): the oracle gate of
# tests/test_pallas.py:177, the round trip of tests/test_bf16.py:263.
SPLIT4_ORACLE_TOL = 1e-4
SPLIT4_SNR_DB = (100.0, 125.0)
# (oracle tolerance x max, lowest SNR, SNR bound it must stay under)
EXACT_GATES = (ORACLE_TOL, MIN_SNR_DB, float("inf"))
SPLIT4_GATES = (SPLIT4_ORACLE_TOL, *SPLIT4_SNR_DB)
# The H100 SXM's peaks (NVIDIA data sheet, dense rates at 700 W).
PEAK_FP32 = 67e12    # FLOP/s outside the tensor cores
PEAK_BF16 = 989e12   # dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12  # HBM3 bytes/s

# name -> (source, TPU kernel it replaces, kernel wrapper, plain version)
KERNELS = {
    "fused": (fused.CUDA_SOURCE, fused.REPLACES, fused.frames_rfft,
              fused.frames_rfft_plain),
    "synth": (synth.CUDA_SOURCE, synth.REPLACES, synth.istft_ola,
              synth.istft_ola_plain),
    "framing": (framing.CUDA_SOURCE, framing.REPLACES, framing.frame_window,
                framing.frame_window_plain),
    "ola": (ola.CUDA_SOURCE, ola.REPLACES, ola.overlap_add,
            ola.overlap_add_plain),
    "frames_op": (fused.CUDA_SOURCE, fused.REPLACES_OP, fused.frames_op,
                  fused.frames_op_plain),
    "imdct_ola": (synth.CUDA_SOURCE, synth.REPLACES_IMDCT, synth.imdct_ola,
                  synth.imdct_ola_plain),
    "spec_rows": (melfused.CUDA_SOURCE, melfused.REPLACES_SPEC,
                  melfused.spec_rows, melfused.spec_rows_plain),
    "mel_rows": (melfused.CUDA_SOURCE, melfused.REPLACES_MEL,
                 melfused.mel_rows, melfused.mel_rows_plain),
    "mel_rows_split4": (melfused.CUDA_SOURCE, melfused.REPLACES_MEL_SPLIT4,
                        melfused.mel_rows_split4,
                        melfused.mel_rows_split4_plain),
    "cqt_magnitudes": (cqtslab.CUDA_SOURCE, cqtslab.REPLACES,
                       cqtslab.cqt_magnitudes, cqtslab.cqt_magnitudes_plain),
    "cqt_magnitudes_split4": (cqtslab.CUDA_SOURCE, cqtslab.REPLACES_SPLIT4,
                              cqtslab.cqt_magnitudes_split4,
                              cqtslab.cqt_magnitudes_split4_plain),
    "mirror_full_planes": (mirror.CUDA_SOURCE, mirror.REPLACES_MIRROR,
                           mirror.mirror_full_planes,
                           mirror.mirror_full_planes_plain),
    "fold_half_planes": (mirror.CUDA_SOURCE, mirror.REPLACES_FOLD,
                         mirror.fold_half_planes,
                         mirror.fold_half_planes_plain),
    "frames_rfft_full": (fused.CUDA_SOURCE, fused.REPLACES_FULL,
                         fused.frames_rfft_full,
                         fused.frames_rfft_full_plain),
    "frames_matmul2": (fused.CUDA_SOURCE, fused.REPLACES_2,
                       fused.frames_matmul2, fused.frames_matmul2_plain),
    "fused_fft": (rfft.CUDA_SOURCE, rfft.REPLACES, rfft.frames_rfft_fft,
                  rfft.frames_rfft_fft_plain),
    "frames_matmul2_fft": (rfft.CUDA_SOURCE, rfft.REPLACES_2,
                           rfft.frames_matmul2_fft,
                           rfft.frames_matmul2_fft_plain),
    "fused_split4": (fused.CUDA_SOURCE, fused.REPLACES_SPLIT4,
                     fused.frames_rfft_split4,
                     fused.frames_rfft_split4_plain),
    "frames_op_split4": (fused.CUDA_SOURCE, fused.REPLACES_SPLIT4,
                         fused.frames_op_split4,
                         fused.frames_op_split4_plain),
    "frames_rfft_full_split4": (fused.CUDA_SOURCE,
                                fused.REPLACES_FULL_SPLIT4,
                                fused.frames_rfft_full_split4,
                                fused.frames_rfft_full_split4_plain),
    "frames_matmul2_split4": (fused.CUDA_SOURCE, fused.REPLACES_2_SPLIT4,
                              fused.frames_matmul2_split4,
                              fused.frames_matmul2_split4_plain),
    "synth_split4": (synth.CUDA_SOURCE, synth.REPLACES_SPLIT4,
                     synth.istft_ola_split4, synth.istft_ola_split4_plain),
    "imdct_ola_split4": (synth.CUDA_SOURCE, synth.REPLACES_SPLIT4,
                         synth.imdct_ola_split4,
                         synth.imdct_ola_split4_plain),
}
# Kernels that store B1's (or its twin's) sums elsewhere: name -> (B1 or
# its twin, the store's function of that output).
RESTORES = {
    "frames_rfft_full": ("fused", fft.conjugate_mirror),
    "frames_rfft_full_split4": ("fused_split4", fft.conjugate_mirror),
    "frames_matmul2": ("fused", lambda half, wl: (half.real, half.imag)),
    "frames_matmul2_split4": ("fused_split4",
                              lambda half, wl: (half.real, half.imag)),
    "frames_matmul2_fft": ("fused_fft",
                           lambda half, wl: (half.real, half.imag)),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def segment(index: int, seconds: int = SEGMENT_SECONDS) -> np.ndarray:
    """Segment ``index`` of the test signal: the two tones and seeded noise
    of tests/make_golden.py (its chirp would pass Nyquist over 600 s)."""
    n = seconds * SR
    t = (np.arange(n, dtype=np.float64) + index * n) / SR
    sig = (0.3 * np.sin(2 * np.pi * 440.0 * t)
           + 0.2 * np.sin(2 * np.pi * 2960.0 * t)
           + 0.05 * np.random.default_rng(SEED + index).standard_normal(n))
    return sig.astype(np.float32)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> None:
    require(torch.cuda.is_available(),
            "torch.cuda.is_available() is false: there is no CPU path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def phase_build() -> None:
    seconds, log = _build.timed_build(verbose=True)
    print(f"build: {seconds:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")


def _kernel_inputs(wl: int, step: int, t: int, dev) -> dict:
    """Inputs at the shapes the main path hands each kernel: a padded
    signal for the analysis kernels (with the operator for the GEMM B1,
    B3 and B12, which an explicit operator selects at a power-of-two
    window), real frames for the OLA, folded planes of a real spectrum for
    the synthesis kernel."""
    sig = np.resize(segment(0), (t - 1) * step + wl).astype(np.float32)
    padded = torch.from_numpy(sig).to(dev)
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
    frames = framing.frame_window_plain(padded, win, wl, step, t)
    half = fused.frames_rfft_plain(padded, win, wl, step, t)
    spec = fft.conjugate_mirror(half, wl)
    h_re, h_im = fft.hermitian_fold_planes(spec.real, spec.imag, wl)
    scale = 1.0 / float(hamming(wl)[::step].sum())
    analysis = (padded, win, wl, step, t)
    gemm = (*analysis, fused.rdft_ops(wl, torch.float32, dev))
    return {
        "fused": (gemm, GEMM_TOL),
        "fused_fft": (analysis, FFT_TOL),
        "frames_matmul2_fft": (analysis, FFT_TOL),
        "synth": ((h_re, h_im, wl, step, scale), GEMM_TOL),
        "framing": (analysis, EXACT_TOL),
        "ola": ((frames.contiguous(), step), EXACT_TOL),
        "mirror_full_planes": ((half, wl), EXACT_TOL),
        "fold_half_planes": ((spec, wl), EXACT_TOL),
        "frames_rfft_full": (gemm, GEMM_TOL),
        "frames_matmul2": (gemm, GEMM_TOL),
        "fused_split4": (analysis, GEMM_TOL),
        "frames_rfft_full_split4": (analysis, GEMM_TOL),
        "frames_matmul2_split4": (analysis, GEMM_TOL),
        "synth_split4": ((h_re, h_im, wl, step, scale), GEMM_TOL),
    }


def _max_abs(a: torch.Tensor) -> float:
    a = torch.view_as_real(a) if a.is_complex() else a
    return float(a.abs().max())


def _cqt_step(cfg: CqtConfig) -> int:
    return round(cfg.sampling_frequency / cfg.time_resolution)


def _signal_and_window(wl: int, step: int, t: int, window, dev):
    """The test signal cut to T frames, and ``window(wl)``, on the card."""
    sig = np.resize(segment(0), (t - 1) * step + wl).astype(np.float32)
    return (torch.from_numpy(sig).to(dev),
            torch.from_numpy(window(wl).astype(np.float32)).to(dev))


def _mdct_ops(wl: int, dev) -> torch.Tensor:
    return torch.from_numpy(tmdct._direct_forward_ops_padded(wl)).to(dev)


def _kernel_cases(dev, main_t: int):
    """``(name, label, shape, args, tol)`` for each kernel at its main-path
    shape and a ragged one, made one at a time."""
    for label, (wl, step, t) in (("main", (WL, STEP, main_t)),
                                 ("ragged", RAGGED)):
        for name, (args, tol) in _kernel_inputs(wl, step, t, dev).items():
            # At WL 2048 only an explicit operator sends B1 / B12 to the
            # GEMM; their main-path shape is the 40-ms window's, below.
            case = ("operator" if label == "main" and name in GEMM_KERNELS
                    else label)
            yield name, case, f"WL {wl} hop {step} T {t}", args, tol
    wl, step, t, rows, offset = FFT_RAGGED
    sig = np.resize(segment(1), rows * ((t - 1) * step + wl) + offset)
    padded = torch.from_numpy(sig.astype(np.float32)).to(dev)[offset:].reshape(
        rows, -1)
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
    for name in ("fused_fft", "frames_matmul2_fft"):
        yield (name, "ragged", f"{rows} rows WL {wl} hop {step} T {t} "
               f"offset {offset}", (padded, win, wl, step, t), FFT_TOL)
    gemm_main_t = stft_padding(SEGMENT_SECONDS * SR, GEMM_WL,
                               GEMM_WL // 2)[2]  # 30,001
    for label, (wl, step, t) in (
            ("main", (GEMM_WL, GEMM_WL // 2, gemm_main_t)),
            ("ragged", GEMM_RAGGED)):
        padded, win = _signal_and_window(wl, step, t, hamming, dev)
        for name in GEMM_KERNELS:
            yield (name, label, f"WL {wl} hop {step} T {t} (no operator)",
                   (padded, win, wl, step, t), GEMM_TOL)
    for label, (wl, step, t) in (("main", (WL, STEP, main_t)),
                                 ("ragged", MDCT_RAGGED)):
        padded, win = _signal_and_window(wl, step, t, vorbis, dev)
        ops = _mdct_ops(wl, dev)
        for name, op in (("frames_op", ops),
                         ("frames_op_split4", policy.presplit(ops))):
            yield (name, label, f"WL {wl} hop {step} T {t}",
                   (padded, win, op, wl // 2, wl, step, t), GEMM_TOL)
    # The IMDCT reads the MDCT coefficients of the test signal.
    for label, (f, t) in (("main", (WL // 2, main_t)),
                          ("ragged", (IMDCT_RAGGED_F, RAGGED[2]))):
        padded, win = _signal_and_window(2 * f, f, t, vorbis, dev)
        coeffs = fused.frames_op_plain(padded, win, _mdct_ops(2 * f, dev), f,
                                       2 * f, f, t)
        for name in ("imdct_ola", "imdct_ola_split4"):
            yield (name, label, f"F {f} T {t}",
                   (coeffs, f, vorbis(2 * f).tobytes()), GEMM_TOL)
    for label, (wl, step, t, mels) in (
            ("main", (WL, STEP, main_t, MelConfig().number_mels)),
            ("ragged", MEL_RAGGED), ("wide", MEL_WIDE)):
        padded, win = _signal_and_window(wl, step, t, hamming, dev)
        if label != "wide":
            yield ("spec_rows", label, f"WL {wl} hop {step} T {t}",
                   (padded, win, wl, step, t), GEMM_TOL)
        fbank_t = torch.from_numpy(np.ascontiguousarray(
            melfilterbank(SR, wl, mels).T.astype(np.float32))).to(dev)
        for name in ("mel_rows", "mel_rows_split4"):
            for power in (False, True):
                yield (name, label,
                       f"WL {wl} hop {step} T {t} mels {mels} power {power}",
                       (padded, win, fbank_t, wl, step, t, power), GEMM_TOL)
    main_cqt_t = SEGMENT_SECONDS * SR // _cqt_step(CqtConfig())  # 15,000
    for label, (cfg, t) in (("main", (CqtConfig(), main_cqt_t)),
                            ("ragged", CQT_RAGGED)):
        kern = cfg.kernel()
        step, length = _cqt_step(cfg), kern.fft_length
        sig = torch.from_numpy(np.resize(
            segment(0), (t - 1) * step + length).astype(np.float32)).to(dev)
        for name, split4 in (("cqt_magnitudes", False),
                             ("cqt_magnitudes_split4", True)):
            yield (name, label,
                   f"L {length} hop {step} T {t} F {kern.number_frequencies}",
                   (sig, tcqt._device_time_kernel(kern, dev, split4), step,
                    length, t, kern.number_frequencies), GEMM_TOL)


def _rows(x: torch.Tensor) -> int:
    """Rows of ``x`` over its last axis (batch and frames together)."""
    return x.numel() // max(x.shape[-1], 1)


def _work(name: str, args: tuple) -> tuple[float, float, float]:
    """Operator-GEMM FLOP, other FLOP and bytes of one call of kernel
    ``name`` on ``args``: the operations the function does and the bytes it
    must move, each input read once and each output written once (an
    operator's bf16 hi and lo are as many bytes as its float32). The split4
    twins do their GEMM in four bf16 passes; the rest is FP32 work."""
    base = name.removesuffix("_split4")
    passes = 4 if base != name else 1  # the split4 twins' bf16 passes
    if base == "synth":
        h_re, _, n, step, _ = args
        b, t, f = _rows(h_re) // h_re.shape[-2], h_re.shape[-2], h_re.shape[-1]
        return (passes * 2 * b * t * 2 * f * n, 0,
                4 * (2 * b * t * f + 2 * f * n + b * ((t - 1) * step + n)))
    if base == "imdct_ola":
        c, f, _ = args
        b, t = _rows(c) // c.shape[-2], c.shape[-2]
        return (passes * 2 * b * t * f * 2 * f, 0,
                4 * (b * t * f + 2 * f * f + b * (t + 1) * f))
    if base == "ola":
        frames, step = args
        t, wl = frames.shape[-2:]
        return 0, t * wl, 4 * (t * wl + (t - 1) * step + wl)
    if base == "mirror_full_planes":
        half, n = args
        return 0, 0, 8 * _rows(half) * (half.shape[-1] + n)
    if base == "fold_half_planes":
        spec, n = args
        rows, f = _rows(spec), n // 2 + 1
        return 0, 6 * rows * f, 8 * rows * (n + f)
    if base == "cqt_magnitudes":
        sig, _, _, length, t, f = args
        b = _rows(sig)
        return (passes * 4 * b * t * length * f, 3 * b * t * f,
                4 * (sig.numel() + 2 * length * f + b * t * f))
    if base in ("fused_fft", "frames_matmul2_fft"):
        # The real FFT: about 2.5 N log2 N operations a frame, and the
        # window; the signal and the window read once, the twiddle table,
        # the half spectrum written once.
        padded, _, wl, _, t = args
        b, f = _rows(padded), wl // 2 + 1
        return (0, b * t * (2.5 * wl * np.log2(wl) + wl),
                4 * (padded.numel() + wl + 2 * wl) + 8 * b * t * f)
    # The analysis kernels: windowed frames times an operator.
    if base == "frames_op":
        padded, _, _, f, wl, _, t = args
        nc, out = 1, 4 * t * f
    elif base == "mel_rows":
        padded, _, fbt, wl, _, t, _ = args
        nc, f = 2, wl // 2
        out = 4 * t * fbt.shape[1]
    else:
        padded, _, wl, _, t = args[:5]
        nc = 2
        f = wl // 2 if base == "spec_rows" else wl // 2 + 1
        out = {"fused": 8 * t * f, "frames_matmul2": 8 * t * f,
               "frames_rfft_full": 8 * t * wl, "spec_rows": 4 * t * f,
               "framing": 4 * t * wl}[base]
    b = _rows(padded)
    inputs = 4 * (padded.numel() + wl)
    if base == "framing":
        return 0, b * t * wl, inputs + b * out
    ops_bytes = 4 * nc * wl * f
    other = 0
    if base == "mel_rows":
        other = 3 * b * t * f + 2 * b * t * f * fbt.shape[1]
        ops_bytes += 4 * f * fbt.shape[1]
    return passes * 2 * nc * b * t * wl * f, other, inputs + ops_bytes + b * out


def bound(name: str, args: tuple) -> tuple[float, str]:
    """The least time in ms the card could take for kernel ``name`` on
    ``args``, and what sets it: the larger of its bytes over the HBM rate
    and its operations over the peak rate for their type (a split4 twin's
    GEMM on the bf16 tensor cores beside its FP32 epilogue, the rest FP32)."""
    gemm, other, nbytes = _work(name, args)
    if name.endswith("_split4"):
        t_ops = max(gemm / PEAK_BF16, other / PEAK_FP32)
    else:
        t_ops = (gemm + other) / PEAK_FP32
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def library_call(name: str, args: tuple):
    """One PyTorch call computing the same function as kernel ``name`` on
    ``args`` (timed beside it, never called by the port), or None."""
    base = name.removesuffix("_split4")
    if base in ("fused", "frames_matmul2", "frames_rfft_full", "fused_fft",
                "frames_matmul2_fft"):
        padded, win, wl, step, _ = args[:5]
        return lambda: torch.stft(padded, wl, step, window=win, center=False,
                                  onesided=base != "frames_rfft_full",
                                  return_complex=True)
    if base == "synth":
        return synth_library(*args)
    if base == "ola":
        frames, step = args
        t, wl = frames.shape
        return lambda: torch.nn.functional.fold(
            frames.T[None], (1, (t - 1) * step + wl), (1, wl),
            stride=(1, step))
    return None


def synth_library(h_re, h_im, wl, step, scale):
    """B4's function as one torch.istft call: a ones window normalises the
    overlap-add by its envelope, WL / hop away from the first and last WL
    samples, so the result times (WL / hop) * scale is B4's there."""
    half = torch.complex(h_re, h_im).transpose(-1, -2)
    ones = torch.ones(wl, device=h_re.device)
    return lambda: torch.istft(half, wl, step, window=ones,
                               center=False) * (wl / step * scale)


def _planes(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the main-path shape and a
    ragged one; returns the main-path error, median times (kernel, plain
    version, library call) and bound (for mel_rows, the largest error of
    its two main cases and the times of the first, power=False)."""
    results = {}
    main_t = stft_padding(SEGMENT_SECONDS * SR, WL, STEP)[2]  # 25,841
    for name, label, shape, args, tol in _kernel_cases(dev, main_t):
        _, _, kernel, plain = KERNELS[name]
        got = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        if name in RESTORES:
            base, store = RESTORES[name]
            sums = _planes(store(KERNELS[base][2](*args), args[2]))
            require(all(torch.equal(a, b) for a, b in zip(_planes(got), sums)),
                    f"{name} {label}: not bit-equal to {base}'s sums")
            print(f"kernel {name} {label}: bit-equal to {base}'s sums")
        if isinstance(got, tuple):  # (re, im) planes
            got, ref = torch.stack(got), torch.stack(ref)
        require(got.shape == ref.shape and got.dtype == ref.dtype,
                f"{name} {label}: {got.shape} {got.dtype} vs "
                f"{ref.shape} {ref.dtype}")
        err = _max_abs(got - ref)
        scale = _max_abs(ref)
        print(f"kernel {name:18s} {label:6s} {shape}: "
              f"max_abs_err {err!r} max|ref| {scale!r}")
        require(np.isfinite(err) and err <= tol * scale,
                f"{name} {label}: max_abs_err {err} > {tol} * {scale}")
        if label == "main":
            ms = median_ms(lambda: kernel(*args))
            plain_ms = median_ms(lambda: plain(*args))
            lib = library_call(name, args)
            library_ms = None if lib is None else median_ms(lib)
            if name.removesuffix("_split4") == "synth":
                wl = args[2]
                lerr = _max_abs((lib() - kernel(*args))[wl:-wl])
                print(f"  {name}: torch.istft yardstick vs kernel, interior "
                      f"max_abs_err {lerr!r}")
                require(lerr <= GEMM_TOL * scale,
                        f"{name}: torch.istft yardstick {lerr} > "
                        f"{GEMM_TOL} * {scale}")
            bound_ms, bound_by = bound(name, args)
            print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library {library_ms} ms (median of 10); bound "
                  f"{bound_ms:.4f} ms by {bound_by}")
            entry = results.setdefault(name, {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        del got, ref, args
        torch.cuda.empty_cache()
    return results


def reset_counters() -> None:
    for _, _, kernel, plain in KERNELS.values():
        kernel.launches = 0
        plain.calls = 0


def read_counters() -> tuple[dict, dict]:
    return ({k: v[2].launches for k, v in KERNELS.items()},
            {k: v[3].calls for k, v in KERNELS.items()})


def check_counters(path: str, want: tuple) -> dict:
    """Fail unless exactly the kernels in ``want`` launched since
    :func:`reset_counters` and no plain version ran; return their counts."""
    launches, plain_calls = read_counters()
    print(f"{path}: launches {launches} plain calls {plain_calls}")
    for name in launches:
        if name in want:
            require(launches[name] >= 1, f"[{path}] {name} never ran")
        else:
            require(launches[name] == 0, f"[{path}] {name} ran")
    require(all(v == 0 for v in plain_calls.values()),
            f"[{path}] a plain version ran: {plain_calls}")
    return {k: launches[k] for k in want}


def snr_db(x: torch.Tensor, rec: torch.Tensor) -> float:
    n = x.shape[-1]
    x64, r64 = x.double(), rec[..., :n].double()
    return float(10 * torch.log10((x64 ** 2).sum() / ((r64 - x64) ** 2).sum()))


def oracle_error(x: torch.Tensor, spec: torch.Tensor, wl: int = WL,
                 step: int = STEP) -> tuple[float, float]:
    """Max |spec - fft(float64 windowed frames)| and max |oracle|; the
    oracle is a check only and never on the path."""
    pad_front, pad_back, t = stft_padding(x.shape[-1], wl, step)
    padded = torch.nn.functional.pad(x.double(), (pad_front, pad_back))
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(x.device)
    frames = padded.unfold(-1, wl, step)[:t] * win.double()
    oracle = torch.fft.fft(frames, dim=-1)
    err = _max_abs(spec.transpose(-1, -2).to(torch.complex128) - oracle)
    return err, _max_abs(oracle)


# dispatch -> the kernels the STFT and the MDCT main paths must run.
STFT_WANT = {"default": ("fused_fft", "synth"), "split": ("framing", "ola"),
             "split4": ("fused_split4", "synth_split4"),
             f"default WL {GEMM_WL}": ("fused", "synth"),
             f"ZAFTPU_FUSED2=1 WL {GEMM_WL}": ("frames_matmul2", "synth")}
MDCT_WANT = {"default": ("frames_op", "imdct_ola"),
             "split": ("framing", "ola"),
             "split4": ("frames_op_split4", "imdct_ola_split4")}


def check_gates(path: str, err: float, scale: float, snr: float,
                gates: tuple) -> None:
    """Fail unless ``err <= tol * scale`` and ``lo <= snr < hi``."""
    tol, lo, hi = gates
    require(err <= tol * scale, f"[{path}] error {err} > {tol} * {scale}")
    require(lo <= snr < hi, f"[{path}] SNR {snr} dB outside [{lo}, {hi})")


def phase_main_path(dispatch: str, x: torch.Tensor) -> dict:
    """One 600-s stft -> istft (WL 2048 / hop 1024, or the 40-ms window
    where the dispatch names it); returns the launch counts of the kernels
    this dispatch must run."""
    wl, step = ((GEMM_WL, GEMM_WL // 2) if dispatch.endswith(f"WL {GEMM_WL}")
                else (WL, STEP))
    win = hamming(wl)
    t = stft_padding(x.shape[-1], wl, step)[2]
    reset_counters()
    spec = zaftpu_torch.stft(x, win, step)
    rec = zaftpu_torch.istft(spec, win, step)
    torch.cuda.synchronize()
    launches = check_counters(f"main path [{dispatch}]", STFT_WANT[dispatch])
    require(tuple(spec.shape) == (wl, t) and spec.dtype == torch.complex64,
            f"[{dispatch}] spectrum {tuple(spec.shape)} {spec.dtype}")
    require(spec.is_cuda and rec.is_cuda, f"[{dispatch}] left the card")
    err, scale = oracle_error(x, spec, wl, step)
    snr = snr_db(x, rec)
    print(f"main path [{dispatch}]: spectrum max_abs_err vs f64 oracle "
          f"{err!r} (max|oracle| {scale!r}, ratio {err / scale!r}); "
          f"round-trip SNR {snr!r} dB; output {tuple(rec.shape)}")
    check_gates(f"main path {dispatch}", err, scale, snr,
                SPLIT4_GATES if dispatch == "split4" else EXACT_GATES)
    return launches


def mdct_oracle(x: torch.Tensor) -> torch.Tensor:
    """MDCT coefficients ``(T, F)`` in float64 by the reference's FFT chain
    (pre-twiddle, FFT, post-twiddle, real part; zaf.py:1036-1071) on the
    card; a check only, never on the path."""
    step = WL // 2
    n = x.shape[-1]
    t = int(np.ceil(n / step)) + 1
    padded = torch.nn.functional.pad(x.double(), (step, (t + 1) * step - n))
    win = torch.from_numpy(vorbis(WL)).to(x.device)
    pre, post = (torch.from_numpy(a).to(x.device)
                 for a in tmdct._forward_twiddles(WL))
    frames = padded.unfold(-1, WL, step)[:t] * win
    return (torch.fft.fft(frames * pre, dim=-1)[:, :step] * post).real


def phase_mdct_path(dispatch: str, x: torch.Tensor) -> dict:
    """One 600-s mdct -> imdct with vorbis(2048); returns the launch counts
    of the kernels this dispatch must run."""
    win = vorbis(WL)
    reset_counters()
    coeffs = zaftpu_torch.mdct(x, win)
    rec = zaftpu_torch.imdct(coeffs, win)
    torch.cuda.synchronize()
    launches = check_counters(f"mdct path [{dispatch}]", MDCT_WANT[dispatch])
    oracle = mdct_oracle(x)
    require(tuple(coeffs.shape) == tuple(oracle.T.shape)
            and coeffs.dtype == torch.float32,
            f"[{dispatch}] coefficients {tuple(coeffs.shape)} {coeffs.dtype}")
    require(coeffs.is_cuda and rec.is_cuda, f"[{dispatch}] left the card")
    err = _max_abs(coeffs.T.double() - oracle)
    scale = _max_abs(oracle)
    snr = snr_db(x, rec)
    print(f"mdct path [{dispatch}]: coefficients max_abs_err vs f64 oracle "
          f"{err!r} (max|oracle| {scale!r}, ratio {err / scale!r}); "
          f"round-trip SNR {snr!r} dB; output {tuple(rec.shape)}")
    check_gates(f"mdct path {dispatch}", err, scale, snr,
                SPLIT4_GATES if dispatch == "split4" else EXACT_GATES)
    return launches


def mel_oracles(x: torch.Tensor, cfg: MelConfig):
    """Float64 spectrogram ``(T, WL/2)``, mel ``(T, M)`` and MFCC ``(T, C)``
    rows from torch.fft on the card; a check only, never on the path."""
    wl, step = cfg.window_length, cfg.step_length
    pad_front, pad_back, t = stft_padding(x.shape[-1], wl, step)
    padded = torch.nn.functional.pad(x.double(), (pad_front, pad_back))
    win = torch.from_numpy(cfg.window_array()).to(x.device)
    frames = padded.unfold(-1, wl, step)[:t] * win
    spec = torch.fft.rfft(frames, dim=-1)[:, 1:].abs()
    fbank_t = torch.from_numpy(cfg.filterbank().T.copy()).to(x.device)
    dct = torch.from_numpy(
        dct_ii_ortho_matrix(cfg.number_mels)).to(x.device)
    logmel = torch.log((spec * spec) @ fbank_t + np.finfo(np.float64).eps)
    return (spec, spec @ fbank_t,
            (logmel @ dct.T)[:, 1:cfg.number_coefficients + 1])


# dispatch -> the kernels the mel phase must run, and the oracle gates of
# spectrogram and melspectrogram (x max|oracle|; the MFCC's is MFCC_ATOL).
MEL_WANT = {"default": (("fused_fft",), ORACLE_TOL, ORACLE_TOL),
            "ZAFTPU_MELFUSE=1": (("spec_rows", "mel_rows"), ORACLE_TOL,
                                 ORACLE_TOL),
            "split4 ZAFTPU_MELFUSE=1": (("spec_rows", "mel_rows_split4"),
                                        ORACLE_TOL, SPLIT4_ORACLE_TOL)}


def phase_mel_path(dispatch: str, x: torch.Tensor) -> dict:
    """spectrogram, melspectrogram and mfcc of the 600-s signal at
    MelConfig(); returns the launch counts of the kernels this dispatch
    must run."""
    cfg = MelConfig()
    reset_counters()
    spec = zaftpu_torch.spectrogram(x, cfg.window_array(), cfg.step_length)
    mel = zaftpu_torch.melspectrogram(x, config=cfg)
    mf = zaftpu_torch.mfcc(x, config=cfg)
    torch.cuda.synchronize()
    want, spec_tol, mel_tol = MEL_WANT[dispatch]
    launches = check_counters(f"mel path [{dispatch}]", want)
    for name, got, oracle, gate in zip(
            ("spectrogram", "melspectrogram", "mfcc"), (spec, mel, mf),
            mel_oracles(x, cfg), (spec_tol, mel_tol, None)):
        require(tuple(got.shape) == tuple(oracle.T.shape)
                and got.dtype == torch.float32 and got.is_cuda,
                f"[{dispatch}] {name} {tuple(got.shape)} {got.dtype} "
                f"{got.device}")
        err = _max_abs(got.T.double() - oracle)
        scale = _max_abs(oracle)
        print(f"mel path [{dispatch}]: {name} max_abs_err vs f64 oracle "
              f"{err!r} (max|oracle| {scale!r}, ratio {err / scale!r})")
        limit = MFCC_ATOL if gate is None else gate * scale
        require(np.isfinite(err) and err <= limit,
                f"[{dispatch}] {name} error {err} > {limit}")
    return launches


def phase_hour(dispatch: str, segs: list) -> None:
    """Six 600-s segments through stft, then istft; frames/s from CUDA
    events, median of 3 passes (printed, not gated)."""
    win = hamming(WL)
    frames = sum(stft_padding(s.shape[-1], WL, STEP)[2] for s in segs)
    zaftpu_torch.istft(zaftpu_torch.stft(segs[0], win, STEP), win, STEP)
    runs = []
    for _ in range(3):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        specs = [zaftpu_torch.stft(s, win, STEP) for s in segs]
        e1.record()
        recs = [zaftpu_torch.istft(s, win, STEP) for s in specs]
        e2.record()
        e2.synchronize()
        runs.append((e0.elapsed_time(e1), e1.elapsed_time(e2)))
        del specs
    stft_ms = statistics.median(r[0] for r in runs)
    istft_ms = statistics.median(r[1] for r in runs)
    snr = min(snr_db(s, r) for s, r in zip(segs, recs))
    print(f"one hour [{dispatch}]: {frames} frames; stft {stft_ms:.3f} ms "
          f"-> {frames / stft_ms * 1e3:,.0f} frames/s; istft "
          f"{istft_ms:.3f} ms -> {frames / istft_ms * 1e3:,.0f} frames/s; "
          f"min segment SNR {snr:.2f} dB (median of 3)")
    del recs


def _hour_ms(fn, segs: list) -> float:
    """Median of 3 CUDA-event times of ``fn`` over every segment, after
    one warm-up segment."""
    fn(segs[0])
    runs = []
    for _ in range(3):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        outs = [fn(s) for s in segs]
        e1.record()
        e1.synchronize()
        runs.append(e0.elapsed_time(e1))
        del outs
    return statistics.median(runs)


def phase_hour_features(dispatch: str, segs: list,
                        mel_only: bool = False) -> None:
    """mdct, imdct (of the mdct's coefficients), spectrogram,
    melspectrogram and mfcc (only the last three when ``mel_only``) over
    the six 600-s segments; frames/s from CUDA events, median of 3 passes
    (printed, not gated)."""
    vwin = vorbis(WL)
    cfg = MelConfig()
    hwin = cfg.window_array()
    coeffs = [] if mel_only else [zaftpu_torch.mdct(s, vwin) for s in segs]
    mdct_frames = sum(c.shape[-1] for c in coeffs)
    stft_frames = sum(stft_padding(s.shape[-1], WL, STEP)[2] for s in segs)
    rates = []
    for name, fn, data, frames in (
            ("mdct", lambda s: zaftpu_torch.mdct(s, vwin), segs,
             mdct_frames),
            ("imdct", lambda c: zaftpu_torch.imdct(c, vwin), coeffs,
             mdct_frames),
            ("spectrogram",
             lambda s: zaftpu_torch.spectrogram(s, hwin, cfg.step_length),
             segs, stft_frames),
            ("melspectrogram",
             lambda s: zaftpu_torch.melspectrogram(s, config=cfg), segs,
             stft_frames),
            ("mfcc", lambda s: zaftpu_torch.mfcc(s, config=cfg), segs,
             stft_frames)):
        if mel_only and name in ("mdct", "imdct"):
            continue
        ms = _hour_ms(fn, data)
        rates.append(f"{name} {ms:.3f} ms -> {frames / ms * 1e3:,.0f} "
                     "frames/s")
    print(f"one hour [{dispatch}]: " + "; ".join(rates) + " (median of 3)")


def cqt_oracle(x: torch.Tensor, cfg: CqtConfig, chunk: int = 256):
    """Float64 CQT spectrogram ``(T, F)`` and chromagram ``(T, OR)`` of
    ``x`` by the reference's chain (zaf.py:613-633): the asymmetric centre
    pad, per-frame FFT, the kernel's non-zero columns, ``abs``, in chunks of
    frames on the card; a check only, never on the path."""
    kern = cfg.kernel()
    step, length = _cqt_step(cfg), kern.fft_length
    t = x.shape[-1] // step
    padded = torch.nn.functional.pad(
        x.double(), (int(np.ceil((length - step) / 2)),
                     int(np.floor((length - step) / 2)) + length))
    cols = np.nonzero(np.any(kern.kernel != 0, axis=0))[0]
    k_cols = torch.from_numpy(kern.kernel[:, cols].T.copy()).to(x.device)
    idx = torch.from_numpy(cols).to(x.device)
    spec = torch.cat([
        (torch.fft.fft(padded[b0 * step:(min(b0 + chunk, t) - 1) * step
                              + length].unfold(-1, length, step),
                       dim=-1)[:, idx] @ k_cols).abs()
        for b0 in range(0, t, chunk)])
    f, bins = spec.shape[-1], cfg.octave_resolution
    octaves = -(-f // bins)
    chroma = torch.nn.functional.pad(spec, (0, octaves * bins - f)).reshape(
        t, octaves, bins).sum(dim=1)
    return spec, chroma


# CQT scheme -> the kernel it must run and its oracle gate (x max|oracle|).
CQT_WANT = {"default": ("cqt_magnitudes_split4", SPLIT4_ORACLE_TOL),
            "ZAFTPU_PRECISION=highest": ("cqt_magnitudes", ORACLE_TOL),
            "ZAFTPU_CQT_SCHEME=exact": ("cqt_magnitudes", ORACLE_TOL)}


def phase_cqt_path(dispatch: str, x: torch.Tensor) -> dict:
    """cqtspectrogram and cqtchromagram of the 600-s signal at CqtConfig();
    returns the launch counts of the CQT kernel this scheme must run."""
    cfg = CqtConfig()
    kernel, tol = CQT_WANT[dispatch]
    reset_counters()
    spec = zaftpu_torch.cqtspectrogram(x, config=cfg)
    chroma = zaftpu_torch.cqtchromagram(x, config=cfg)
    torch.cuda.synchronize()
    launches = check_counters(f"cqt path [{dispatch}]", (kernel,))
    for name, got, oracle in zip(("cqtspectrogram", "cqtchromagram"),
                                 (spec, chroma), cqt_oracle(x, cfg)):
        require(tuple(got.shape) == tuple(oracle.T.shape)
                and got.dtype == torch.float32 and got.is_cuda,
                f"[{dispatch}] {name} {tuple(got.shape)} {got.dtype} "
                f"{got.device}")
        err = _max_abs(got.T.double() - oracle)
        scale = _max_abs(oracle)
        print(f"cqt path [{dispatch}]: {name} max_abs_err vs f64 oracle "
              f"{err!r} (max|oracle| {scale!r}, ratio {err / scale!r})")
        require(np.isfinite(err) and err <= tol * scale,
                f"[{dispatch}] {name} error {err} > {tol} * {scale}")
    return launches


def phase_fullspec_path(dispatch: str, x: torch.Tensor, ref: tuple,
                        want: tuple, gates: tuple, bit_equal: bool) -> dict:
    """stft -> istft of the 600-s signal under a mirror, full-spectrum or
    two-output lever: the spectrum and the round trip bit-equal to the
    ``ref`` of the dispatch without the lever where ``bit_equal`` (the two
    share a kernel tile), and its ``gates``; returns the launch counts of
    the kernels in ``want``."""
    win = hamming(WL)
    reset_counters()
    spec = zaftpu_torch.stft(x, win, STEP)
    rec = zaftpu_torch.istft(spec, win, STEP)
    torch.cuda.synchronize()
    launches = check_counters(f"full-spectrum path [{dispatch}]", want)
    if bit_equal:
        require(torch.equal(spec, ref[0]),
                f"[{dispatch}] spectrum differs from the lever-free one's")
        require(torch.equal(rec, ref[1]),
                f"[{dispatch}] round trip differs from the lever-free one's")
        how = "bit-equal to the lever-free dispatch's"
    else:
        how = (f"against the lever-free dispatch's: spectrum max_abs_err "
               f"{_max_abs(spec - ref[0])!r}, round trip "
               f"{_max_abs(rec - ref[1])!r}")
    err, scale = oracle_error(x, spec)
    snr = snr_db(x, rec)
    print(f"full-spectrum path [{dispatch}]: spectrum and round trip {how}; "
          f"spectrum max_abs_err vs f64 oracle "
          f"{err!r} (ratio {err / scale!r}); round-trip SNR {snr!r} dB")
    check_gates(f"full-spectrum path {dispatch}", err, scale, snr, gates)
    return launches


def phase_hour_cqt(dispatch: str, segs: list) -> None:
    """cqtspectrogram and cqtchromagram over the six 600-s segments;
    frames/s from CUDA events, median of 3 passes (printed, not gated)."""
    cfg = CqtConfig()
    frames = sum(s.shape[-1] // _cqt_step(cfg) for s in segs)
    rates = []
    for name, fn in (("cqtspectrogram", zaftpu_torch.cqtspectrogram),
                     ("cqtchromagram", zaftpu_torch.cqtchromagram)):
        ms = _hour_ms(lambda s, fn=fn: fn(s, config=cfg), segs)
        rates.append(f"{name} {ms:.3f} ms -> {frames / ms * 1e3:,.0f} "
                     "frames/s")
    print(f"one hour [cqt {dispatch}]: {frames} frames; " + "; ".join(rates)
          + " (median of 3)")


LEVERS = ("ZAFTPU_FUSED", "ZAFTPU_SYNTH", "ZAFTPU_MELFUSE", "ZAFTPU_MIRROR",
          "ZAFTPU_FULLSPEC", "ZAFTPU_FUSED2", "ZAFTPU_PRECISION",
          "ZAFTPU_CQT_SCHEME")
DEFAULT = dict.fromkeys(LEVERS)
SPLIT = {**DEFAULT, "ZAFTPU_FUSED": "0", "ZAFTPU_SYNTH": "0",
         "ZAFTPU_MELFUSE": "0"}
MELFUSE_ON = {**DEFAULT, "ZAFTPU_MELFUSE": "1"}
MIRROR_ON = {**DEFAULT, "ZAFTPU_MIRROR": "pallas"}
FULLSPEC_ON = {**DEFAULT, "ZAFTPU_FULLSPEC": "1"}
FUSED2_ON = {**DEFAULT, "ZAFTPU_FUSED2": "1"}
SPLIT4 = {**DEFAULT, "ZAFTPU_PRECISION": "split4"}
SPLIT4_FUSED2 = {**SPLIT4, "ZAFTPU_FUSED2": "1"}
SPLIT4_FULLSPEC = {**SPLIT4, "ZAFTPU_FULLSPEC": "1"}
SPLIT4_MELFUSE = {**SPLIT4, "ZAFTPU_MELFUSE": "1"}
CQT_HIGHEST = {**DEFAULT, "ZAFTPU_PRECISION": "highest"}
CQT_EXACT = {**DEFAULT, "ZAFTPU_CQT_SCHEME": "exact"}


def _with_env(env: dict, fn, *args):
    """Run ``fn`` with each variable of ``env`` set to its value (None:
    unset), restoring the environment after."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        return fn(*args)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _default_stft_istft(x: torch.Tensor) -> tuple:
    win = hamming(WL)
    spec = zaftpu_torch.stft(x, win, STEP)
    return spec, zaftpu_torch.istft(spec, win, STEP)


def main() -> int:
    start = time.perf_counter()
    os.environ["ZAFTPU_CACHE"] = "0"
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    timings = phase_kernels(dev)

    x = torch.from_numpy(segment(0)).to(dev)
    launches = {name: 0 for name in KERNELS}
    for env, phase, dispatch in (
            (DEFAULT, phase_main_path, "default"),
            (SPLIT, phase_main_path, "split"),
            (DEFAULT, phase_main_path, f"default WL {GEMM_WL}"),
            (FUSED2_ON, phase_main_path, f"ZAFTPU_FUSED2=1 WL {GEMM_WL}"),
            (DEFAULT, phase_mdct_path, "default"),
            (SPLIT, phase_mdct_path, "split"),
            (DEFAULT, phase_mel_path, "default"),
            (MELFUSE_ON, phase_mel_path, "ZAFTPU_MELFUSE=1"),
            (DEFAULT, phase_cqt_path, "default"),
            (CQT_HIGHEST, phase_cqt_path, "ZAFTPU_PRECISION=highest"),
            (CQT_EXACT, phase_cqt_path, "ZAFTPU_CQT_SCHEME=exact"),
            (SPLIT4, phase_main_path, "split4"),
            (SPLIT4, phase_mdct_path, "split4"),
            (SPLIT4_MELFUSE, phase_mel_path, "split4 ZAFTPU_MELFUSE=1")):
        for name, count in _with_env(env, phase, dispatch, x).items():
            launches[name] += count
        torch.cuda.empty_cache()
    for base, gates, levers in (
            (DEFAULT, EXACT_GATES, (
                (MIRROR_ON, "ZAFTPU_MIRROR=pallas",
                 ("fused_fft", "mirror_full_planes", "fold_half_planes",
                  "synth"), True),
                (FULLSPEC_ON, "ZAFTPU_FULLSPEC=1",
                 ("frames_rfft_full", "synth"), False),
                (FUSED2_ON, "ZAFTPU_FUSED2=1",
                 ("frames_matmul2_fft", "synth"), True))),
            (SPLIT4, SPLIT4_GATES, (
                (SPLIT4_FUSED2, "split4 ZAFTPU_FUSED2=1",
                 ("frames_matmul2_split4", "synth_split4"), True),
                (SPLIT4_FULLSPEC, "split4 ZAFTPU_FULLSPEC=1",
                 ("frames_rfft_full_split4", "synth_split4"), True)))):
        ref = _with_env(base, _default_stft_istft, x)
        for env, dispatch, want, bit_equal in levers:
            for name, count in _with_env(env, phase_fullspec_path, dispatch,
                                         x, ref, want, gates,
                                         bit_equal).items():
                launches[name] += count
            torch.cuda.empty_cache()
        del ref
    del x
    torch.cuda.empty_cache()

    segs = [torch.from_numpy(segment(i)).to(dev)
            for i in range(SEGMENTS_PER_HOUR)]
    for env, dispatch in ((DEFAULT, "default"), (SPLIT, "split"),
                          (SPLIT4, "split4")):
        _with_env(env, phase_hour, dispatch, segs)
        _with_env(env, phase_hour_features, dispatch, segs)
        torch.cuda.empty_cache()
    for env, dispatch in ((MELFUSE_ON, "ZAFTPU_MELFUSE=1"),
                          (SPLIT4_MELFUSE, "split4 ZAFTPU_MELFUSE=1")):
        _with_env(env, phase_hour_features, dispatch, segs, True)
    for env, dispatch in ((DEFAULT, "default: split4"),
                          (CQT_EXACT, "ZAFTPU_CQT_SCHEME=exact")):
        _with_env(env, phase_hour_cqt, dispatch, segs)
        torch.cuda.empty_cache()

    print(f"chip_smoke: {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name], **timings[name]}
        for name, (source, replaces, _, _) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
