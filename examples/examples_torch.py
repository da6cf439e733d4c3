"""The reference's 12 examples and Griffin-Lim (examples/examples.py's 13)
against zaftpu_torch.

Each ``example_*`` builds its inputs as tensors on ``device`` (float32 on
the card, the kernels' dtype, as ``zaftpu`` computes a float64 array on its
accelerator; float64 on the CPU, the oracle mode, as ``zaftpu`` under x64),
runs the port's public functions there and returns the same dict of NumPy
arrays as its ``zaftpu`` counterpart. With ``draw=True`` (the default) it
also draws its figure with the port's display helpers and saves it as a
PNG in ``outdir``; the arrays need no matplotlib. Run all::

    python examples/examples_torch.py [outdir] [--device cuda|cpu]

Audio: the recording ``ZAFTPU_FIXTURE`` names when the file exists, else
examples/examples.py's synthetic stereo stand-in.
"""

from __future__ import annotations

import argparse
import os
import sys

if __name__ == "__main__":  # run from a checkout: the repository on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import zaftpu_torch  # noqa: E402
from zaftpu_torch import asnumpy  # noqa: E402
from zaftpu_torch.core.windows import hamming, kbd, vorbis  # noqa: E402

FIXTURE = os.environ.get("ZAFTPU_FIXTURE", "")
NUMERALS = ("I", "II", "III", "IV")


def load_audio():
    """Stereo signal + rate: the recording or a synthetic fallback
    (examples/examples.py's)."""
    if FIXTURE and os.path.exists(FIXTURE):
        return zaftpu_torch.wavread(FIXTURE)
    sr = 44100
    t = np.arange(8 * sr) / sr
    left = 0.5 * np.sin(2 * np.pi * (220 + 110 * t) * t)
    right = 0.4 * np.sin(2 * np.pi * 330 * t)
    return np.stack([left, right], axis=1), sr


def _tensor(x, device) -> torch.Tensor:
    """``x`` on ``device``: float32 on the card, float64 on the CPU."""
    dtype = torch.float32 if torch.device(device).type == "cuda" else (
        torch.float64)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(plt, outdir, name):
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, name))
    plt.close()


def _analysis_params(sr):
    wl = 2 ** int(np.ceil(np.log2(0.04 * sr)))
    return wl, hamming(wl, periodic=True), wl // 2


def example_stft(outdir, device="cuda", draw=True):
    """Compute and display the spectrogram of an audio file."""
    audio, sr = load_audio()
    mono = _tensor(audio.mean(axis=1), device)
    wl, window, step = _analysis_params(sr)
    spec = zaftpu_torch.stft(mono, window, step)[1:wl // 2 + 1].abs()
    if draw:
        plt = _plt()
        plt.figure(figsize=(14, 7))
        zaftpu_torch.specshow(spec, len(mono), sr, xtick_step=1,
                              ytick_step=1000)
        plt.title("Spectrogram (dB)")
        _save(plt, outdir, "stft.png")
    return {"spec": asnumpy(spec)}


def example_istft(outdir, device="cuda", draw=True):
    """Estimate the center and sides from a stereo file (masked ISTFT)."""
    audio, sr = load_audio()
    wl, window, step = _analysis_params(sr)
    x = _tensor(audio, device)
    stft1 = zaftpu_torch.stft(x[:, 0], window, step)
    stft2 = zaftpu_torch.stft(x[:, 1], window, step)
    nf = wl // 2 + 1
    mag1, mag2 = stft1[:nf].abs(), stft2[:nf].abs()
    mask1 = torch.minimum(mag1, mag2) / mag1.clamp(min=1e-30)
    mask2 = torch.minimum(mag1, mag2) / mag2.clamp(min=1e-30)
    # The mirror of bins 1..WL/2-1, as the reference's mask[-2:0:-1].
    center1 = torch.cat((mask1, mask1[1:-1].flip(0))) * stft1
    center2 = torch.cat((mask2, mask2[1:-1].flip(0))) * stft2
    sig1 = zaftpu_torch.istft(center1, window, step)
    sig2 = zaftpu_torch.istft(center2, window, step)
    center = asnumpy(torch.stack([sig1, sig2], dim=1))[:len(audio)]
    sides = audio[:len(center)] - center
    zaftpu_torch.wavwrite(center, sr, os.path.join(outdir, "center_file.wav"))
    zaftpu_torch.wavwrite(sides, sr, os.path.join(outdir, "sides_file.wav"))
    if draw:
        plt = _plt()
        plt.figure(figsize=(14, 7))
        for i, (sig, title) in enumerate([(audio, "Original signal"),
                                          (center, "Center signal"),
                                          (sides, "Sides signal")]):
            plt.subplot(3, 1, i + 1)
            zaftpu_torch.sigplot(sig, sr, xtick_step=1)
            plt.ylim(-1, 1)
            plt.title(title)
        _save(plt, outdir, "istft.png")
    return {"center": center, "sides": sides}


def example_melfilterbank(outdir, device="cuda", draw=True):
    """Compute and display the mel filterbank (a host operator)."""
    fbank = zaftpu_torch.melfilterbank(44100, 2048, 128)
    if draw:
        plt = _plt()
        plt.figure(figsize=(14, 5))
        plt.imshow(fbank, aspect="auto", cmap="jet", origin="lower")
        plt.title("Mel filterbank")
        plt.xlabel("Frequency index")
        plt.ylabel("Mel index")
        _save(plt, outdir, "melfilterbank.png")
    return {"fbank": np.asarray(fbank)}


def example_melspectrogram(outdir, device="cuda", draw=True):
    """Compute and display the mel spectrogram."""
    audio, sr = load_audio()
    mono = _tensor(audio.mean(axis=1), device)
    wl, window, step = _analysis_params(sr)
    fbank = zaftpu_torch.melfilterbank(sr, wl, 128)
    melspec = zaftpu_torch.melspectrogram(mono, window, step, fbank)
    if draw:
        plt = _plt()
        plt.figure(figsize=(14, 5))
        zaftpu_torch.melspecshow(melspec, len(mono), sr, wl, xtick_step=1)
        plt.title("Mel spectrogram (dB)")
        _save(plt, outdir, "melspectrogram.png")
    return {"melspec": asnumpy(melspec)}


def example_mfcc(outdir, device="cuda", draw=True):
    """Compute and display MFCCs, delta MFCCs, and delta-delta MFCCs."""
    audio, sr = load_audio()
    mono = _tensor(audio.mean(axis=1), device)
    wl, window, step = _analysis_params(sr)
    fbank = zaftpu_torch.melfilterbank(sr, wl, 40)
    mfccs = zaftpu_torch.mfcc(mono, window, step, fbank, 20)
    dmfccs = torch.diff(mfccs, n=1, dim=1)
    ddmfccs = torch.diff(dmfccs, n=1, dim=1)
    if draw:
        plt = _plt()
        plt.figure(figsize=(14, 7))
        for i, (m, title) in enumerate([(mfccs, "MFCCs"),
                                        (dmfccs, "Delta MFCCs"),
                                        (ddmfccs, "Delta-delta MFCCs")]):
            plt.subplot(3, 1, i + 1)
            zaftpu_torch.mfccshow(m, len(mono), sr, xtick_step=1)
            plt.title(title)
        _save(plt, outdir, "mfcc.png")
    return {"mfccs": asnumpy(mfccs), "dmfccs": asnumpy(dmfccs),
            "ddmfccs": asnumpy(ddmfccs)}


def example_cqtkernel(outdir, device="cuda", draw=True):
    """Compute and display a CQT kernel (a host operator)."""
    kernel = zaftpu_torch.cqtkernel(44100, 24, 55, 22050)
    magnitude = np.abs(kernel.toarray())
    if draw:
        plt = _plt()
        plt.figure(figsize=(14, 5))
        plt.imshow(magnitude, aspect="auto", cmap="jet", origin="lower")
        plt.title("Magnitude CQT kernel")
        plt.xlabel("FFT index")
        plt.ylabel("CQT index")
        _save(plt, outdir, "cqtkernel.png")
    return {"kernel_mag": magnitude}


def example_cqtspectrogram(outdir, device="cuda", draw=True):
    """Compute and display a CQT spectrogram."""
    audio, sr = load_audio()
    mono = _tensor(audio.mean(axis=1), device)
    kernel = zaftpu_torch.cqtkernel(sr, 24, 55, 3520)
    spec = zaftpu_torch.cqtspectrogram(mono, sr, 25, kernel)
    if draw:
        plt = _plt()
        plt.figure(figsize=(14, 5))
        zaftpu_torch.cqtspecshow(spec, 25, 24, 55, xtick_step=1)
        plt.title("CQT spectrogram (dB)")
        _save(plt, outdir, "cqtspectrogram.png")
    return {"spec": asnumpy(spec)}


def example_cqtchromagram(outdir, device="cuda", draw=True):
    """Compute and display a CQT chromagram."""
    audio, sr = load_audio()
    mono = _tensor(audio.mean(axis=1), device)
    kernel = zaftpu_torch.cqtkernel(sr, 24, 55, 3520)
    chroma = zaftpu_torch.cqtchromagram(mono, sr, 25, 24, kernel)
    if draw:
        plt = _plt()
        plt.figure(figsize=(14, 3))
        zaftpu_torch.cqtchromshow(chroma, 25, xtick_step=1)
        plt.title("CQT chromagram")
        _save(plt, outdir, "cqtchromagram.png")
    return {"chroma": asnumpy(chroma)}


def _triple_plot(plt, rows, titles):
    """Three rows of four line plots: ``rows[r][i]`` under ``titles[r][i]``."""
    for r, (arrays, names) in enumerate(zip(rows, titles)):
        for i, (arr, name) in enumerate(zip(arrays, names)):
            plt.subplot(3, 4, 4 * r + i + 1)
            plt.plot(arr)
            plt.autoscale(tight=True)
            plt.title(name)


def example_dct(outdir, device="cuda", draw=True):
    """Compute the 4 DCTs and compare to SciPy's."""
    import scipy.fftpack

    audio, sr = load_audio()
    segment = audio.mean(axis=1)[:1024]
    x = _tensor(segment, device)
    outs = {}
    refs = {}
    for ttype in (1, 2, 3, 4):
        mine = asnumpy(zaftpu_torch.dct(x, ttype))
        refs[ttype] = scipy.fftpack.dct(segment, type=ttype, norm="ortho")
        outs[f"dct{ttype}"] = mine
        outs[f"dct{ttype}_diff"] = mine - refs[ttype]
    if draw:
        plt = _plt()
        plt.figure(figsize=(14, 7))
        _triple_plot(
            plt,
            [[outs[f"dct{t}"] for t in (1, 2, 3, 4)],
             [refs[t] for t in (1, 2, 3, 4)],
             [outs[f"dct{t}_diff"] for t in (1, 2, 3, 4)]],
            [[f"DCT-{n}" for n in NUMERALS], ["SciPy"] * 4,
             ["Difference"] * 4])
        _save(plt, outdir, "dct.png")
    return outs


def example_dst(outdir, device="cuda", draw=True):
    """Compute the 4 DSTs and verify their inverses recover the audio."""
    audio, sr = load_audio()
    segment = audio.mean(axis=1)[:1024]
    x = _tensor(segment, device)
    outs = {}
    recs = {}
    for fwd, inv in [(1, 1), (2, 3), (3, 2), (4, 4)]:
        fwd_out = zaftpu_torch.dst(x, fwd)
        rec = zaftpu_torch.dst(fwd_out, inv)
        outs[f"dst{fwd}"] = asnumpy(fwd_out)
        outs[f"dst{fwd}_recon_err"] = asnumpy(rec - x)
        recs[fwd] = asnumpy(rec)
    if draw:
        plt = _plt()
        plt.figure(figsize=(14, 7))
        _triple_plot(
            plt,
            [[outs[f"dst{t}"] for t in (1, 2, 3, 4)],
             [recs[t] for t in (1, 2, 3, 4)],
             [outs[f"dst{t}_recon_err"] for t in (1, 2, 3, 4)]],
            [[f"DST-{n}" for n in NUMERALS],
             ["Inverse"] * 4, ["Inverse - original"] * 4])
        _save(plt, outdir, "dst.png")
    return outs


def example_mdct(outdir, device="cuda", draw=True):
    """Compute and display the MDCT with the AC-3 KBD window."""
    audio, sr = load_audio()
    mono = _tensor(audio.mean(axis=1), device)
    coeffs = zaftpu_torch.mdct(mono, kbd(512, 5.0)).abs()
    if draw:
        plt = _plt()
        plt.figure(figsize=(14, 7))
        zaftpu_torch.specshow(coeffs, len(mono), sr, xtick_step=1,
                              ytick_step=1000)
        plt.title("MDCT (dB)")
        _save(plt, outdir, "mdct.png")
    return {"coeffs": asnumpy(coeffs)}


def example_imdct(outdir, device="cuda", draw=True):
    """Verify that the MDCT (Vorbis window) is perfectly invertible."""
    audio, sr = load_audio()
    mono = _tensor(audio.mean(axis=1), device)
    window = vorbis(2048)
    coeffs = zaftpu_torch.mdct(mono, window)
    rec = zaftpu_torch.imdct(coeffs, window)[:len(mono)]
    diff = mono[:len(rec)] - rec
    if draw:
        plt = _plt()
        y_max = float(diff.abs().max())
        plt.figure(figsize=(14, 7))
        for i, (sig, title, ylim) in enumerate(
                [(mono, "Original signal", 1),
                 (rec, "Resynthesized signal", 1),
                 (diff, "Original - resynthesized", y_max)]):
            plt.subplot(3, 1, i + 1)
            zaftpu_torch.sigplot(sig, sr, xtick_step=1)
            plt.ylim(-ylim, ylim)
            plt.title(title)
        _save(plt, outdir, "imdct.png")
    return {"rec": asnumpy(rec), "diff": asnumpy(diff)}


def example_griffinlim(outdir, device="cuda", draw=True):
    """Reconstruct audio from a magnitude spectrogram (beyond the
    reference: fast Griffin-Lim phase recovery), in float32 on every
    device, as examples/examples.py runs it."""
    audio, sr = load_audio()
    mono = torch.as_tensor(audio.mean(axis=1)[:10 * sr], dtype=torch.float32,
                           device=device)
    wl, window, step = _analysis_params(sr)
    window = window.astype(np.float32)
    magnitude = zaftpu_torch.stft(mono, window, step)[:wl // 2 + 1].abs()
    rebuilt = asnumpy(zaftpu_torch.griffin_lim(magnitude, window, step,
                                               iterations=50))
    zaftpu_torch.wavwrite(rebuilt, sr, os.path.join(outdir, "griffinlim.wav"))
    if draw:
        plt = _plt()
        plt.figure(figsize=(14, 7))
        for i, (sig, title) in enumerate(
                [(mono, "Original signal"),
                 (rebuilt, "Griffin-Lim reconstruction")]):
            plt.subplot(2, 1, i + 1)
            zaftpu_torch.sigplot(sig, sr, xtick_step=1)
            plt.ylim(-1, 1)
            plt.title(title)
        _save(plt, outdir, "griffinlim.png")
    return {"rebuilt": rebuilt}


def array_stats(arr):
    """Statistical fingerprint of one plotted array (examples/examples.py's):
    shape, finite fraction, value range, mean and RMS, in float64."""
    a = np.asarray(arr, dtype=np.float64)
    finite = np.isfinite(a)
    af = a[finite] if finite.any() else np.zeros(1)
    return {
        "shape": list(a.shape),
        "finite_frac": float(finite.mean()),
        "min": float(af.min()),
        "max": float(af.max()),
        "mean": float(af.mean()),
        "rms": float(np.sqrt(np.mean(af * af))),
    }


def fingerprint(outs):
    """Per-array stats for one example's returned plotted arrays."""
    return {name: array_stats(val) for name, val in sorted(outs.items())}


ALL = [example_stft, example_istft, example_melfilterbank,
       example_melspectrogram, example_mfcc, example_cqtkernel,
       example_cqtspectrogram, example_cqtchromagram, example_dct,
       example_dst, example_mdct, example_imdct, example_griffinlim]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run the 13 examples against zaftpu_torch.")
    parser.add_argument("outdir", nargs="?", default="example_output")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to run the "
                           "examples on the CPU")
    os.makedirs(args.outdir, exist_ok=True)
    for fn in ALL:
        print(f"running {fn.__name__} ...", flush=True)
        fn(args.outdir, device=args.device)
    print(f"wrote {len(ALL)} figures to {args.outdir}/")


if __name__ == "__main__":
    main()
