"""Drive the zaftpu_torch STFT -> ISTFT path once on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a) and ``nvcc``. Phases, in order; any failure stops the run with a
non-zero exit and no result line:

1. device: the card's name and power limit (as nvidia-smi gives them),
   torch and CUDA versions; TF32 off for matmuls and cuDNN;
2. build: the four kernels from zaftpu_torch/csrc, with the seconds taken;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main-path shape (WL 2048, hop 1024, a 600-s segment: T = 25,841)
   and a ragged one (WL 512, hop 128, T = 1,001); framing and OLA must be
   bit-equal, fused and synth within 2e-5 * max|ref|; median times of
   kernel and plain version at the main-path shape (CUDA events);
4. main path, default dispatch: stft -> istft of a 600-s signal with the
   periodic Hamming window; the spectrum against a float64 torch.fft oracle
   (<= 1e-5 * max|oracle|), the round-trip SNR (>= 120 dB), and launch
   counts showing the fused kernels ran and no plain version did;
5. main path, split dispatch (ZAFTPU_FUSED=0 ZAFTPU_SYNTH=0): the same
   checks, with the framing and OLA kernels;
6. one hour: six 600-s segments through stft, then istft, under both
   dispatches; frames/s from CUDA events (printed, not gated).

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
from zaftpu_torch.core import fft
from zaftpu_torch.core.frame import stft_padding
from zaftpu_torch.core.windows import hamming
from zaftpu_torch.kernels import _build, framing, fused, ola, synth

SR = 44100
SEGMENT_SECONDS = 600
SEGMENTS_PER_HOUR = 6
WL, STEP = 2048, 1024
RAGGED = (512, 128, 1001)  # WL, hop, T
SEED = 20260816
EXACT_TOL = 0.0
GEMM_TOL = 2e-5     # x max|ref|; TF32 would read about 1e-3
ORACLE_TOL = 1e-5   # x max|oracle|
MIN_SNR_DB = 120.0

# name -> (module, kernel wrapper, plain version)
KERNELS = {
    "fused": (fused, fused.frames_rfft, fused.frames_rfft_plain),
    "synth": (synth, synth.istft_ola, synth.istft_ola_plain),
    "framing": (framing, framing.frame_window, framing.frame_window_plain),
    "ola": (ola, ola.overlap_add, ola.overlap_add_plain),
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
    spec = fft.full_from_half(
        fused.frames_rfft_plain(padded, win, wl, step, t), wl)
    h_re, h_im = fft.hermitian_fold_planes(spec.real, spec.imag, wl)
    scale = 1.0 / float(hamming(wl)[::step].sum())
    return {
        "fused": ((padded, win, wl, step, t), GEMM_TOL),
        "synth": ((h_re, h_im, wl, step, scale), GEMM_TOL),
        "framing": ((padded, win, wl, step, t), EXACT_TOL),
        "ola": ((frames.contiguous(), step), EXACT_TOL),
    }


def _max_abs(a: torch.Tensor) -> float:
    a = torch.view_as_real(a) if a.is_complex() else a
    return float(a.abs().max())


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the main-path shape and a
    ragged one; returns the main-path error and median times."""
    results = {}
    main_t = stft_padding(SEGMENT_SECONDS * SR, WL, STEP)[2]  # 25,841
    for label, (wl, step, t) in (("main", (WL, STEP, main_t)),
                                 ("ragged", RAGGED)):
        for name, (args, tol) in _kernel_inputs(wl, step, t, dev).items():
            _, kernel, plain = KERNELS[name]
            got = kernel(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            require(got.shape == ref.shape and got.dtype == ref.dtype,
                    f"{name} {label}: {got.shape} {got.dtype} vs "
                    f"{ref.shape} {ref.dtype}")
            err = _max_abs(got - ref)
            scale = _max_abs(ref)
            print(f"kernel {name:8s} {label:6s} WL {wl} hop {step} T {t}: "
                  f"max_abs_err {err!r} max|ref| {scale!r}")
            require(np.isfinite(err) and err <= tol * scale,
                    f"{name} {label}: max_abs_err {err} > {tol} * {scale}")
            if label == "main":
                ms = median_ms(lambda: kernel(*args))
                plain_ms = median_ms(lambda: plain(*args))
                print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                      "ms (median of 10)")
                results[name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms}
            del got, ref
        torch.cuda.empty_cache()
    return results


def reset_counters() -> None:
    for _, kernel, plain in KERNELS.values():
        kernel.launches = 0
        plain.calls = 0


def read_counters() -> tuple[dict, dict]:
    return ({k: v[1].launches for k, v in KERNELS.items()},
            {k: v[2].calls for k, v in KERNELS.items()})


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
    launches, plain_calls = read_counters()
    print(f"main path [{dispatch}]: launches {launches} plain calls "
          f"{plain_calls}")
    require(tuple(spec.shape) == (WL, t) and spec.dtype == torch.complex64,
            f"[{dispatch}] spectrum {tuple(spec.shape)} {spec.dtype}")
    require(spec.is_cuda and rec.is_cuda, f"[{dispatch}] left the card")
    want = ("fused", "synth") if dispatch == "default" else ("framing", "ola")
    for name in launches:
        if name in want:
            require(launches[name] >= 1, f"[{dispatch}] {name} never ran")
        else:
            require(launches[name] == 0, f"[{dispatch}] {name} ran")
    require(all(v == 0 for v in plain_calls.values()),
            f"[{dispatch}] a plain version ran: {plain_calls}")
    err, scale = oracle_error(x, spec)
    snr = snr_db(x, rec)
    print(f"main path [{dispatch}]: spectrum max_abs_err vs f64 oracle "
          f"{err!r} (max|oracle| {scale!r}, ratio {err / scale!r}); "
          f"round-trip SNR {snr!r} dB; output {tuple(rec.shape)}")
    require(err <= ORACLE_TOL * scale,
            f"[{dispatch}] spectrum error {err} > {ORACLE_TOL} * {scale}")
    require(snr >= MIN_SNR_DB, f"[{dispatch}] SNR {snr} dB < {MIN_SNR_DB}")
    return {k: launches[k] for k in want}


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


def _with_dispatch(split: bool, fn, *args):
    """Run ``fn`` with ZAFTPU_FUSED/ZAFTPU_SYNTH set to 0 (split) or unset
    (default), restoring the environment after."""
    saved = {k: os.environ.get(k) for k in ("ZAFTPU_FUSED", "ZAFTPU_SYNTH")}
    for k in saved:
        if split:
            os.environ[k] = "0"
        else:
            os.environ.pop(k, None)
    try:
        return fn(*args)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main() -> int:
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    timings = phase_kernels(dev)

    x = torch.from_numpy(segment(0)).to(dev)
    launches = _with_dispatch(False, phase_main_path, "default", x)
    launches.update(_with_dispatch(True, phase_main_path, "split", x))
    del x
    torch.cuda.empty_cache()

    segs = [torch.from_numpy(segment(i)).to(dev)
            for i in range(SEGMENTS_PER_HOUR)]
    _with_dispatch(False, phase_hour, "default", segs)
    _with_dispatch(True, phase_hour, "split", segs)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": mod.CUDA_SOURCE,
         "replaces": mod.REPLACES, "launches": launches[name],
         **timings[name]}
        for name, (mod, _, _) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
