"""Where the device time of zaftpu_torch's main path goes, on a CUDA card.

    python3 scripts/torch_profile.py [--precision highest|split4] [--iters 3]
        [--window 1102] [--only mdct|cqt|mel|istft]

Profiles 600-s stft -> istft, mdct -> imdct (the chip_smoke.py signal,
Hamming and vorbis windows of 2048, hop 1024; --window sets the STFT's
Hamming window, at half overlap), cqtspectrogram at
CqtConfig(), from 27.5 Hz (L 65,536) and from 16.35 Hz (L 131,072; on the
path the environment selects, then under ZAFTPU_FFT=matmul: the
time-domain kernels), one hour of stft (six 600-s
segments queued back to back)
and one hour of stft, then istft (chip_smoke.py's hour phase) with
torch.profiler after two
warm-up iterations, under the
given ZAFTPU_PRECISION (set explicitly, so the CQT's time-domain kernels
run the split4 twin under split4 and the exact kernel under highest) and
the other levers as
set in the environment; the CQT kernel is built without the disk cache. Prints, per path and per iteration: the device
time of each kernel (largest first), the busy time (their sum), the window
(host clock around the profiled iterations, synchronised) and the busy
share; for the hours, also the host operators that take the most host
time of their own. ``--only mdct`` profiles the MDCT instead: 600-s mdct ->
imdct, mdct alone and imdct alone, and one hour of mdct, then imdct (set
ZAFTPU_FFT=matmul to profile the GEMMs B2 and B7, or their twins, at WL
2048). ``--only cqt`` profiles the CQT alone: 600-s cqtspectrogram at
CqtConfig() and from 27.5 and 16.35 Hz, and one hour of it at
CqtConfig(), each on the selected path and under ZAFTPU_FFT=matmul.
``--only mel`` profiles the mel front ends: 600-s melspectrogram and mfcc
at MelConfig() and melspectrogram at Whisper's front end (16 kHz, Hann 400
/ hop 160, 80 mels: the signal's first 600 s of samples read at 16 kHz),
each on the selected path (the real-FFT kernel's mel store by default) and
under ZAFTPU_MELFUSE=0 (the half store, ``|·|`` and the filterbank
product). ``--only istft`` profiles the STFT's synthesis: 600-s stft ->
istft and istft alone at --window, half overlap.
Needs a CUDA card; prints nothing else and exits 1 without one.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import zaftpu_torch  # noqa: E402
from chip_smoke import segment  # noqa: E402
from zaftpu_torch import CqtConfig, MelConfig  # noqa: E402
from zaftpu_torch.core.windows import hamming, vorbis  # noqa: E402

WL = 2048


def device_ms(event) -> float:
    """An event's own device time in ms (the attribute's name moved)."""
    total = getattr(event, "self_device_time_total", None)
    if total is None:
        total = event.self_cuda_time_total
    return total / 1e3


def profile(name: str, fn, iters: int, host_rows: int = 0) -> None:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3 / iters
    rows = [(device_ms(e) / iters, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and device_ms(e) > 0]
    rows.sort(reverse=True)
    busy = sum(ms for ms, _ in rows)
    print(f"{name}: busy {busy:.3f} ms / window {window:.3f} ms "
          f"({100 * busy / window:.2f}%) per iteration, {iters} iterations")
    for ms, key in rows:
        print(f"  {ms:9.4f} ms  {100 * ms / busy:6.2f}%  {key[:90]}")
    host = sorted(((e.self_cpu_time_total / 1e3 / iters, e.count // iters,
                    e.key) for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), reverse=True)
    for ms, count, key in host[:host_rows]:
        print(f"  host {ms:9.4f} ms  {count:5d} calls  {key[:80]}")


def profile_mdct(x: torch.Tensor, vw, iters: int) -> None:
    """The MDCT's paths with vorbis(2048): the 600-s round trip, each
    direction alone, and one hour of mdct, then imdct."""
    profile("mdct -> imdct", lambda: zaftpu_torch.imdct(
        zaftpu_torch.mdct(x, vw), vw), iters)
    profile("mdct", lambda: zaftpu_torch.mdct(x, vw), iters)
    coeffs = zaftpu_torch.mdct(x, vw)
    profile("imdct", lambda: zaftpu_torch.imdct(coeffs, vw), iters)
    del coeffs
    segs = [torch.from_numpy(segment(i)).cuda() for i in range(6)]

    def hour_round_trip():
        coeffs = [zaftpu_torch.mdct(s, vw) for s in segs]
        return [zaftpu_torch.imdct(c, vw) for c in coeffs]

    profile("mdct, then imdct, one hour", hour_round_trip, iters,
            host_rows=8)


def profile_cqt(x: torch.Tensor, iters: int, hour: bool) -> None:
    """cqtspectrogram at CqtConfig() (L 32,768), from 27.5 Hz (L 65,536) and
    from 16.35 Hz (C0: L 131,072) on the path the environment selects (the
    spectral kernel by default; its two-block cluster at L 65,536, its
    four-block cluster at L 131,072) and again under ZAFTPU_FFT=matmul (the
    time-domain kernels B10-s4 and B10): 600 s and, with ``hour``, one hour
    at CqtConfig()."""
    segs = ([torch.from_numpy(segment(i)).cuda() for i in range(6)]
            if hour else [])
    saved = os.environ.get("ZAFTPU_FFT")
    try:
        for fft in (saved, "matmul"):
            if fft is not None:
                os.environ["ZAFTPU_FFT"] = fft
            for name, cfg in (("CqtConfig()", CqtConfig()),
                              ("27.5 Hz", CqtConfig(minimum_frequency=27.5)),
                              ("16.35 Hz", CqtConfig(minimum_frequency=16.35))):
                label = f"cqtspectrogram {name} [ZAFTPU_FFT={fft or 'auto'}]"
                profile(label, lambda: zaftpu_torch.cqtspectrogram(
                    x, config=cfg), iters)
                if hour and name == "CqtConfig()":
                    profile(label + ", one hour", lambda: [
                        zaftpu_torch.cqtspectrogram(s, config=cfg)
                        for s in segs], iters, host_rows=8)
    finally:
        if saved is None:
            os.environ.pop("ZAFTPU_FFT", None)
        else:
            os.environ["ZAFTPU_FFT"] = saved


def profile_mel(x: torch.Tensor, iters: int) -> None:
    """melspectrogram and mfcc of 600 s at MelConfig(), and melspectrogram
    at Whisper's front end, on the path the environment selects and under
    ZAFTPU_MELFUSE=0."""
    cfg = MelConfig()
    whisper = MelConfig(sampling_frequency=16000, window_length=400,
                        step_length=160, number_mels=80, window="hann")
    x16 = x[:600 * 16000]
    saved = os.environ.get("ZAFTPU_MELFUSE")
    try:
        for melfuse in (saved, "0"):
            if melfuse is not None:
                os.environ["ZAFTPU_MELFUSE"] = melfuse
            tag = f"[ZAFTPU_MELFUSE={melfuse or 'auto'}]"
            profile(f"melspectrogram {tag}", lambda: zaftpu_torch.
                    melspectrogram(x, config=cfg), iters)
            profile(f"mfcc {tag}", lambda: zaftpu_torch.mfcc(
                x, config=cfg), iters)
            profile(f"melspectrogram 16 kHz WL 400 {tag}", lambda:
                    zaftpu_torch.melspectrogram(x16, config=whisper), iters)
    finally:
        if saved is None:
            os.environ.pop("ZAFTPU_MELFUSE", None)
        else:
            os.environ["ZAFTPU_MELFUSE"] = saved


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--precision", default="highest",
                        choices=("highest", "split4"))
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--window", type=int, default=WL)
    parser.add_argument("--only", choices=("all", "mdct", "cqt", "mel",
                                           "istft"),
                        default="all")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    os.environ["ZAFTPU_PRECISION"] = args.precision
    os.environ["ZAFTPU_CACHE"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}; ZAFTPU_PRECISION="
          f"{args.precision}; ZAFTPU_FFT="
          f"{os.environ.get('ZAFTPU_FFT', 'auto')}; STFT window {args.window}")
    x = torch.from_numpy(segment(0)).cuda()
    step = args.window // 2
    hw, vw = hamming(args.window), vorbis(WL)
    if args.only == "mdct":
        profile_mdct(x, vw, args.iters)
        return 0
    if args.only == "cqt":
        profile_cqt(x, args.iters, hour=True)
        return 0
    if args.only == "mel":
        profile_mel(x, args.iters)
        return 0
    if args.only == "istft":
        profile("stft -> istft", lambda: zaftpu_torch.istft(
            zaftpu_torch.stft(x, hw, step), hw, step), args.iters)
        spec = zaftpu_torch.stft(x, hw, step)
        profile("istft", lambda: zaftpu_torch.istft(spec, hw, step),
                args.iters)
        return 0
    profile("stft -> istft", lambda: zaftpu_torch.istft(
        zaftpu_torch.stft(x, hw, step), hw, step), args.iters)
    profile("stft", lambda: zaftpu_torch.stft(x, hw, step), args.iters)
    profile("mdct -> imdct", lambda: zaftpu_torch.imdct(
        zaftpu_torch.mdct(x, vw), vw), args.iters)
    profile_cqt(x, args.iters, hour=False)
    segs = [torch.from_numpy(segment(i)).cuda() for i in range(6)]
    profile("stft, one hour", lambda: [zaftpu_torch.stft(s, hw, step)
                                       for s in segs], args.iters,
            host_rows=8)

    def hour_round_trip():
        specs = [zaftpu_torch.stft(s, hw, step) for s in segs]
        return [zaftpu_torch.istft(s, hw, step) for s in specs]

    profile("stft, then istft, one hour", hour_round_trip, args.iters,
            host_rows=12)
    return 0


if __name__ == "__main__":
    sys.exit(main())
