"""Drive the zaftpu_torch STFT -> ISTFT, MDCT -> IMDCT, spectrogram / mel /
MFCC and CQT paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a) and ``nvcc``. Phases, in order; any failure stops the run with a
non-zero exit and no result line:

1. device: the card's name and power limit (as nvidia-smi gives them),
   torch and CUDA versions; TF32 off for matmuls and cuDNN;
2. build: the twelve kernels from zaftpu_torch/csrc (one nvcc per source,
   all started together), with the seconds taken;
3. kernels: each kernel against its plain PyTorch version on the card at
   its main-path shape (WL 2048, hop 1024, a 600-s segment: T = 25,841;
   F = 1,024 for the IMDCT; 40 mels; the CQT at CqtConfig(): T = 15,000,
   L = 32,768, hop 1764, F = 144) and a ragged one (WL 512, hop 128,
   T = 1,001 for the STFT, mirror and fold kernels; WL 512 / hop 256 for
   frames_op; F = 100 for imdct_ola; WL 512 / hop 128 with 20 mels for
   spec_rows and mel_rows; the CQT at 22,050 Hz, 12 bins per octave,
   110-3,520 Hz: L 4,096, hop 882, F 60, T 1,001); framing, OLA, mirror and
   fold must be bit-equal, the GEMM kernels within 2e-5 * max|ref|; median
   times of kernel and plain version at the main-path shape (CUDA events);
4. STFT main path, default dispatch: stft -> istft of a 600-s signal with
   the periodic Hamming window; the spectrum against a float64 torch.fft
   oracle (<= 1e-5 * max|oracle|), the round-trip SNR (>= 120 dB), and
   launch counts showing the fused kernels ran and no plain version did;
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
   MFCC atol 5e-3), under the default dispatch (spec_rows and mel_rows, not
   the fused STFT kernel) and ZAFTPU_MELFUSE=0 (the fused STFT kernel);
8. CQT main path at CqtConfig() (44.1 kHz, 24 bins per octave, 55-3,520
   Hz, 25 frames/s): cqtspectrogram and cqtchromagram of the 600-s signal
   against a float64 oracle on the card (per-frame FFT times the kernel's
   non-zero columns, then abs, zaf.py:627-633; <= 1e-5 * max|oracle|), and
   launch counts showing cqt_magnitudes ran and no plain version did;
9. full-spectrum levers: stft -> istft of the 600-s signal under
   ZAFTPU_MIRROR=pallas (fused, mirror_full_planes, fold_half_planes,
   synth), then ZAFTPU_FULLSPEC=1 (frames_rfft_full, synth): spectrum and
   round trip bit-equal to the default dispatch's, and the oracle and SNR
   gates of phase 4;
10. one hour: six 600-s segments through stft, then istft; mdct, then
   imdct; spectrogram; melspectrogram; mfcc, under the default and the
   split dispatch; cqtspectrogram and cqtchromagram (90,000 frames);
   frames/s from CUDA events (printed, not gated).

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

import numpy as np
import torch

import zaftpu_torch
from zaftpu_torch import CqtConfig, MelConfig
from zaftpu_torch.core import fft
from zaftpu_torch.core.frame import stft_padding
from zaftpu_torch.core.windows import hamming, vorbis
from zaftpu_torch.features.mel import dct_ii_ortho_matrix, melfilterbank
from zaftpu_torch.kernels import (_build, cqtslab, framing, fused, melfused,
                                  mirror, ola, synth)
from zaftpu_torch.transforms import mdct as tmdct

SR = 44100
SEGMENT_SECONDS = 600
SEGMENTS_PER_HOUR = 6
WL, STEP = 2048, 1024
RAGGED = (512, 128, 1001)  # WL, hop, T
MDCT_RAGGED = (512, 256, 1001)  # frames_op: WL, hop, T
IMDCT_RAGGED_F = 100  # imdct_ola: F, 16-row padding of the contraction
MEL_RAGGED = (512, 128, 1001, 20)  # spec_rows / mel_rows: WL, hop, T, mels
CQT_RAGGED = (CqtConfig(sampling_frequency=22050, octave_resolution=12,
                        minimum_frequency=110.0), 1001)  # L 4096, hop 882
SEED = 20260816
EXACT_TOL = 0.0
GEMM_TOL = 2e-5     # x max|ref|; TF32 would read about 1e-3
ORACLE_TOL = 1e-5   # x max|oracle|
MIN_SNR_DB = 120.0
MFCC_ATOL = 5e-3    # float32 against float64, tests/test_mel.py:70

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
    "cqt_magnitudes": (cqtslab.CUDA_SOURCE, cqtslab.REPLACES,
                       cqtslab.cqt_magnitudes, cqtslab.cqt_magnitudes_plain),
    "mirror_full_planes": (mirror.CUDA_SOURCE, mirror.REPLACES_MIRROR,
                           mirror.mirror_full_planes,
                           mirror.mirror_full_planes_plain),
    "fold_half_planes": (mirror.CUDA_SOURCE, mirror.REPLACES_FOLD,
                         mirror.fold_half_planes,
                         mirror.fold_half_planes_plain),
    "frames_rfft_full": (fused.CUDA_SOURCE, fused.REPLACES_FULL,
                         fused.frames_rfft_full,
                         fused.frames_rfft_full_plain),
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
    signal for the analysis kernels, real frames for the OLA, folded planes
    of a real spectrum for the synthesis kernel."""
    sig = np.resize(segment(0), (t - 1) * step + wl).astype(np.float32)
    padded = torch.from_numpy(sig).to(dev)
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
    frames = framing.frame_window_plain(padded, win, wl, step, t)
    half = fused.frames_rfft_plain(padded, win, wl, step, t)
    spec = fft.conjugate_mirror(half, wl)
    h_re, h_im = fft.hermitian_fold_planes(spec.real, spec.imag, wl)
    scale = 1.0 / float(hamming(wl)[::step].sum())
    return {
        "fused": ((padded, win, wl, step, t), GEMM_TOL),
        "synth": ((h_re, h_im, wl, step, scale), GEMM_TOL),
        "framing": ((padded, win, wl, step, t), EXACT_TOL),
        "ola": ((frames.contiguous(), step), EXACT_TOL),
        "mirror_full_planes": ((half, wl), EXACT_TOL),
        "fold_half_planes": ((spec, wl), EXACT_TOL),
        "frames_rfft_full": ((padded, win, wl, step, t), GEMM_TOL),
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
            yield name, label, f"WL {wl} hop {step} T {t}", args, tol
    for label, (wl, step, t) in (("main", (WL, STEP, main_t)),
                                 ("ragged", MDCT_RAGGED)):
        padded, win = _signal_and_window(wl, step, t, vorbis, dev)
        yield ("frames_op", label, f"WL {wl} hop {step} T {t}",
               (padded, win, _mdct_ops(wl, dev), wl // 2, wl, step, t),
               GEMM_TOL)
    # The IMDCT reads the MDCT coefficients of the test signal.
    for label, (f, t) in (("main", (WL // 2, main_t)),
                          ("ragged", (IMDCT_RAGGED_F, RAGGED[2]))):
        padded, win = _signal_and_window(2 * f, f, t, vorbis, dev)
        coeffs = fused.frames_op_plain(padded, win, _mdct_ops(2 * f, dev), f,
                                       2 * f, f, t)
        yield ("imdct_ola", label, f"F {f} T {t}",
               (coeffs, f, vorbis(2 * f).tobytes()), GEMM_TOL)
    for label, (wl, step, t, mels) in (
            ("main", (WL, STEP, main_t, MelConfig().number_mels)),
            ("ragged", MEL_RAGGED)):
        padded, win = _signal_and_window(wl, step, t, hamming, dev)
        yield ("spec_rows", label, f"WL {wl} hop {step} T {t}",
               (padded, win, wl, step, t), GEMM_TOL)
        fbank_t = torch.from_numpy(np.ascontiguousarray(
            melfilterbank(SR, wl, mels).T.astype(np.float32))).to(dev)
        for power in (False, True):
            yield ("mel_rows", label,
                   f"WL {wl} hop {step} T {t} mels {mels} power {power}",
                   (padded, win, fbank_t, wl, step, t, power), GEMM_TOL)
    main_cqt_t = SEGMENT_SECONDS * SR // _cqt_step(CqtConfig())  # 15,000
    for label, (cfg, t) in (("main", (CqtConfig(), main_cqt_t)),
                            ("ragged", CQT_RAGGED)):
        kern = cfg.kernel()
        step, length = _cqt_step(cfg), kern.fft_length
        sig = np.resize(segment(0), (t - 1) * step + length)
        ops = torch.from_numpy(cqtslab.time_ops(kern.time_kernel)).to(dev)
        yield ("cqt_magnitudes", label,
               f"L {length} hop {step} T {t} F {kern.number_frequencies}",
               (torch.from_numpy(sig.astype(np.float32)).to(dev), ops, step,
                length, t, kern.number_frequencies), GEMM_TOL)


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the main-path shape and a
    ragged one; returns the main-path error and median times (for
    mel_rows, the largest error of its two main cases and the times of
    the first, power=False)."""
    results = {}
    main_t = stft_padding(SEGMENT_SECONDS * SR, WL, STEP)[2]  # 25,841
    for name, label, shape, args, tol in _kernel_cases(dev, main_t):
        _, _, kernel, plain = KERNELS[name]
        got = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        if isinstance(got, tuple):  # the fold's (re, im) planes
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
            print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  "ms (median of 10)")
            entry = results.setdefault(name, {"max_abs_err": err, "ms": ms,
                                              "plain_ms": plain_ms})
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


def oracle_error(x: torch.Tensor, spec: torch.Tensor) -> tuple[float, float]:
    """Max |spec - fft(float64 windowed frames)| and max |oracle|; the
    oracle is a check only and never on the path."""
    pad_front, pad_back, t = stft_padding(x.shape[-1], WL, STEP)
    padded = torch.nn.functional.pad(x.double(), (pad_front, pad_back))
    win = torch.from_numpy(hamming(WL).astype(np.float32)).to(x.device)
    frames = padded.unfold(-1, WL, STEP)[:t] * win.double()
    oracle = torch.fft.fft(frames, dim=-1)
    err = _max_abs(spec.transpose(-1, -2).to(torch.complex128) - oracle)
    return err, _max_abs(oracle)


def phase_main_path(dispatch: str, x: torch.Tensor) -> dict:
    """One 600-s stft -> istft; returns the launch counts of the kernels
    this dispatch must run."""
    win = hamming(WL)
    t = stft_padding(x.shape[-1], WL, STEP)[2]
    reset_counters()
    spec = zaftpu_torch.stft(x, win, STEP)
    rec = zaftpu_torch.istft(spec, win, STEP)
    torch.cuda.synchronize()
    want = ("fused", "synth") if dispatch == "default" else ("framing", "ola")
    launches = check_counters(f"main path [{dispatch}]", want)
    require(tuple(spec.shape) == (WL, t) and spec.dtype == torch.complex64,
            f"[{dispatch}] spectrum {tuple(spec.shape)} {spec.dtype}")
    require(spec.is_cuda and rec.is_cuda, f"[{dispatch}] left the card")
    err, scale = oracle_error(x, spec)
    snr = snr_db(x, rec)
    print(f"main path [{dispatch}]: spectrum max_abs_err vs f64 oracle "
          f"{err!r} (max|oracle| {scale!r}, ratio {err / scale!r}); "
          f"round-trip SNR {snr!r} dB; output {tuple(rec.shape)}")
    require(err <= ORACLE_TOL * scale,
            f"[{dispatch}] spectrum error {err} > {ORACLE_TOL} * {scale}")
    require(snr >= MIN_SNR_DB, f"[{dispatch}] SNR {snr} dB < {MIN_SNR_DB}")
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
    want = (("frames_op", "imdct_ola") if dispatch == "default"
            else ("framing", "ola"))
    launches = check_counters(f"mdct path [{dispatch}]", want)
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
    require(err <= ORACLE_TOL * scale,
            f"[{dispatch}] MDCT error {err} > {ORACLE_TOL} * {scale}")
    require(snr >= MIN_SNR_DB, f"[{dispatch}] SNR {snr} dB < {MIN_SNR_DB}")
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
    want = (("spec_rows", "mel_rows") if dispatch == "default"
            else ("fused",))
    launches = check_counters(f"mel path [{dispatch}]", want)
    for name, got, oracle, gate in zip(
            ("spectrogram", "melspectrogram", "mfcc"), (spec, mel, mf),
            mel_oracles(x, cfg), (ORACLE_TOL, ORACLE_TOL, None)):
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


def phase_hour_features(dispatch: str, segs: list) -> None:
    """mdct, imdct (of the mdct's coefficients), spectrogram,
    melspectrogram and mfcc over the six 600-s segments; frames/s from
    CUDA events, median of 3 passes (printed, not gated)."""
    vwin = vorbis(WL)
    cfg = MelConfig()
    hwin = cfg.window_array()
    coeffs = [zaftpu_torch.mdct(s, vwin) for s in segs]
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


def phase_cqt_path(dispatch: str, x: torch.Tensor) -> dict:
    """cqtspectrogram and cqtchromagram of the 600-s signal at CqtConfig();
    returns the launch counts of cqt_magnitudes."""
    cfg = CqtConfig()
    reset_counters()
    spec = zaftpu_torch.cqtspectrogram(x, config=cfg)
    chroma = zaftpu_torch.cqtchromagram(x, config=cfg)
    torch.cuda.synchronize()
    launches = check_counters(f"cqt path [{dispatch}]", ("cqt_magnitudes",))
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
        require(np.isfinite(err) and err <= ORACLE_TOL * scale,
                f"[{dispatch}] {name} error {err} > {ORACLE_TOL} * {scale}")
    return launches


def phase_fullspec_path(dispatch: str, x: torch.Tensor, ref: tuple,
                        want: tuple) -> dict:
    """stft -> istft of the 600-s signal under a mirror or full-spectrum
    lever: the spectrum and the round trip bit-equal to the default
    dispatch's ``ref``, and phase 4's gates; returns the launch counts of
    the kernels in ``want``."""
    win = hamming(WL)
    reset_counters()
    spec = zaftpu_torch.stft(x, win, STEP)
    rec = zaftpu_torch.istft(spec, win, STEP)
    torch.cuda.synchronize()
    launches = check_counters(f"full-spectrum path [{dispatch}]", want)
    require(torch.equal(spec, ref[0]),
            f"[{dispatch}] spectrum differs from the default dispatch's")
    require(torch.equal(rec, ref[1]),
            f"[{dispatch}] round trip differs from the default dispatch's")
    err, scale = oracle_error(x, spec)
    snr = snr_db(x, rec)
    print(f"full-spectrum path [{dispatch}]: spectrum and round trip "
          f"bit-equal to the default's; spectrum max_abs_err vs f64 oracle "
          f"{err!r} (ratio {err / scale!r}); round-trip SNR {snr!r} dB")
    require(err <= ORACLE_TOL * scale,
            f"[{dispatch}] spectrum error {err} > {ORACLE_TOL} * {scale}")
    require(snr >= MIN_SNR_DB, f"[{dispatch}] SNR {snr} dB < {MIN_SNR_DB}")
    return launches


def phase_hour_cqt(segs: list) -> None:
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
    print(f"one hour [cqt]: {frames} frames; " + "; ".join(rates)
          + " (median of 3)")


LEVERS = ("ZAFTPU_FUSED", "ZAFTPU_SYNTH", "ZAFTPU_MELFUSE", "ZAFTPU_MIRROR",
          "ZAFTPU_FULLSPEC")
DEFAULT = dict.fromkeys(LEVERS)
SPLIT = {**DEFAULT, "ZAFTPU_FUSED": "0", "ZAFTPU_SYNTH": "0",
         "ZAFTPU_MELFUSE": "0"}
MELFUSE_OFF = {**DEFAULT, "ZAFTPU_MELFUSE": "0"}
MIRROR_ON = {**DEFAULT, "ZAFTPU_MIRROR": "pallas"}
FULLSPEC_ON = {**DEFAULT, "ZAFTPU_FULLSPEC": "1"}


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
            (DEFAULT, phase_mdct_path, "default"),
            (SPLIT, phase_mdct_path, "split"),
            (DEFAULT, phase_mel_path, "default"),
            (MELFUSE_OFF, phase_mel_path, "ZAFTPU_MELFUSE=0"),
            (DEFAULT, phase_cqt_path, "default")):
        for name, count in _with_env(env, phase, dispatch, x).items():
            launches[name] += count
        torch.cuda.empty_cache()
    ref = _with_env(DEFAULT, _default_stft_istft, x)
    for env, dispatch, want in (
            (MIRROR_ON, "ZAFTPU_MIRROR=pallas",
             ("fused", "mirror_full_planes", "fold_half_planes", "synth")),
            (FULLSPEC_ON, "ZAFTPU_FULLSPEC=1", ("frames_rfft_full",
                                                "synth"))):
        for name, count in _with_env(env, phase_fullspec_path, dispatch, x,
                                     ref, want).items():
            launches[name] += count
        torch.cuda.empty_cache()
    del x, ref
    torch.cuda.empty_cache()

    segs = [torch.from_numpy(segment(i)).to(dev)
            for i in range(SEGMENTS_PER_HOUR)]
    for env, dispatch in ((DEFAULT, "default"), (SPLIT, "split")):
        _with_env(env, phase_hour, dispatch, segs)
        _with_env(env, phase_hour_features, dispatch, segs)
        torch.cuda.empty_cache()
    _with_env(DEFAULT, phase_hour_cqt, segs)

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
