"""Windows above 4,096 in zaftpu_torch on the CPU: stft, istft,
spectrogram, melspectrogram, mfcc, mdct and imdct at WL 4,098, 5,000 and
8,192 against zaftpu on the same seeded signal, with ZAFTPU_FFT=matmul on
both sides (the four-step engine at 8,192, torch.fft / jnp.fft at the
other two) and with the default lever (torch.fft / jnp.fft on the CPU):
float64 within 1e-12 * max, float32 within 2e-6 * max (MFCC atol 1e-3);
the split4 dial gives the exact dial's values bit for bit there (no GEMM
of these paths is one the dial lowers), every lever does too, and the
dispatch runs the framing and OLA kernels' plain versions and nothing
else. On the card the same paths run the framing and OLA kernels
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

import zaftpu
import zaftpu_torch
from conftest import snr_db
from zaftpu.core.windows import hamming, vorbis
from zaftpu_torch.kernels import (framing, fused, irfft, melfft, melfused,
                                  ola, rfft, synth)
from zaftpu_torch.kernels import mdct as kmdct

WINDOWS = [4098, 5000, 8192]
SR = 44100
N_MELS, N_MFCC = 40, 20


@pytest.fixture(scope="module")
def signal64():
    return np.random.default_rng(14).standard_normal(3 * 8192 + 123)


@pytest.fixture
def dial(monkeypatch):
    """Set ZAFTPU_PRECISION for both packages (zaftpu's caches cleared, as
    tests/test_torch_split4.py does)."""
    def set_dial(value):
        monkeypatch.setenv("ZAFTPU_PRECISION", value)
        jax.clear_caches()
    yield set_dial
    jax.clear_caches()


def _close(mine, ref, tol, atol=0.0):
    mine = mine.detach().numpy() if isinstance(mine, torch.Tensor) else mine
    ref = np.asarray(ref)
    assert mine.shape == ref.shape and mine.dtype == ref.dtype
    err = float(np.abs(mine.astype(np.complex128) - ref).max())
    assert err <= max(tol * float(np.abs(ref).max()), atol), err


def _outputs(pkg, x, wl):
    """Every long-window path of ``pkg`` on ``x`` (a numpy array for
    zaftpu, a CPU tensor for the port): name -> output."""
    win, step = hamming(wl), wl // 2
    if isinstance(x, torch.Tensor):
        win = win.astype(np.float32) if x.dtype == torch.float32 else win
    else:
        win = win.astype(x.dtype)
    tdac = vorbis(wl).astype(win.dtype)
    fb = pkg.melfilterbank(SR, wl, N_MELS)
    spec = pkg.stft(x, win, step)
    coeffs = pkg.mdct(x, tdac)
    return {"stft": spec, "istft": pkg.istft(spec, win, step),
            "spectrogram": pkg.spectrogram(x, win, step),
            "melspectrogram": pkg.melspectrogram(x, win, step, fb),
            "mfcc": pkg.mfcc(x, win, step, fb, N_MFCC),
            "mdct": coeffs, "imdct": pkg.imdct(coeffs, tdac)}


def _compare(mine, theirs, tol):
    for name in theirs:
        _close(mine[name], theirs[name], tol,
               1e-3 if name == "mfcc" and tol > 1e-9 else 0.0)


@pytest.mark.parametrize("lever", ["matmul", "auto"])
@pytest.mark.parametrize("wl", WINDOWS)
def test_long_windows_match_zaftpu_f64(signal64, wl, lever, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", lever)
    _compare(_outputs(zaftpu_torch, torch.from_numpy(signal64), wl),
             _outputs(zaftpu, signal64, wl), 1e-12)


@pytest.mark.parametrize("lever", ["matmul", "auto"])
@pytest.mark.parametrize("wl", WINDOWS)
def test_long_windows_match_zaftpu_f32_on_both_dials(signal64, wl, lever,
                                                     dial, monkeypatch):
    """float32 within 2e-6 * max on the exact dial; under split4 the port's
    values are the exact dial's bit for bit, and zaftpu's split4 values
    stay within the same bound."""
    monkeypatch.setenv("ZAFTPU_FFT", lever)
    x32 = signal64.astype(np.float32)
    exact = _outputs(zaftpu_torch, torch.from_numpy(x32), wl)
    _compare(exact, _outputs(zaftpu, x32, wl), 2e-6)
    dial("split4")
    split4 = _outputs(zaftpu_torch, torch.from_numpy(x32), wl)
    for name, value in exact.items():
        assert torch.equal(split4[name], value), name
    _compare(split4, _outputs(zaftpu, x32, wl), 2e-6)


@pytest.mark.parametrize("wl", WINDOWS)
def test_round_trips_and_float64_oracle(signal64, wl):
    """The float32 stft -> istft and mdct -> imdct round trips stay above
    120 dB, and the spectrum within 1e-6 * max of numpy's float64 FFT of
    the frames."""
    x32 = torch.from_numpy(signal64.astype(np.float32))
    win, step = hamming(wl), wl // 2
    spec = zaftpu_torch.stft(x32, win.astype(np.float32), step)
    rec = zaftpu_torch.istft(spec, win, step).numpy()
    assert snr_db(signal64, rec) > 120
    ref = np.asarray(zaftpu.stft(signal64, win, step))
    _close(spec.to(torch.complex128), ref, 1e-6)
    rec = zaftpu_torch.imdct(zaftpu_torch.mdct(x32, vorbis(wl)),
                             vorbis(wl)).numpy()
    assert snr_db(signal64, rec) > 120


def test_batched_long_window(signal64, monkeypatch):
    """Leading axes ride the frames' rows (the four-step engine packs them
    in pairs): each row equals its own call."""
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    x = torch.from_numpy(np.stack([signal64, signal64[::-1],
                                   np.roll(signal64, 9)]))
    win = hamming(8192)
    spec = zaftpu_torch.stft(x, win, 4096)
    rec = zaftpu_torch.istft(spec, win, 4096)
    coeffs = zaftpu_torch.mdct(x, vorbis(8192))
    for i in range(3):
        _close(spec[i], zaftpu_torch.stft(x[i], win, 4096).numpy(), 1e-13)
        _close(rec[i], zaftpu_torch.istft(spec[i], win, 4096).numpy(), 1e-13)
        _close(coeffs[i], zaftpu_torch.mdct(x[i], vorbis(8192)).numpy(),
               1e-13)


LEVERS = [("ZAFTPU_FUSED", "0"), ("ZAFTPU_SYNTH", "0"),
          ("ZAFTPU_FULLSPEC", "1"), ("ZAFTPU_FULLSPEC", "0"),
          ("ZAFTPU_MIRROR", "pallas"), ("ZAFTPU_FUSED2", "1"),
          ("ZAFTPU_MELFUSE", "1"), ("ZAFTPU_MELFUSE", "0")]


@pytest.mark.parametrize("lever,value", LEVERS)
def test_levers_leave_long_windows_unchanged(signal64, lever, value,
                                             monkeypatch):
    """Above 4,096 every lever takes the same composition, so the values
    stay bit for bit."""
    x = torch.from_numpy(signal64.astype(np.float32))
    ref = _outputs(zaftpu_torch, x, 8192)
    monkeypatch.setenv(lever, value)
    for name, value in _outputs(zaftpu_torch, x, 8192).items():
        assert torch.equal(value, ref[name]), name


def test_dispatch_runs_framing_and_ola_only(signal64):
    """The CPU follows the card's dispatch: above 4,096 the framing and OLA
    kernels' plain versions run, and no FFT, GEMM or mel kernel's does."""
    plains = [framing.frame_window_plain, ola.overlap_add_plain,
              fused.frames_rfft_plain, fused.frames_rfft_full_plain,
              fused.frames_op_plain, synth.istft_ola_plain,
              synth.imdct_ola_plain, rfft.frames_rfft_fft_plain,
              rfft.frames_rfft_full_fft_plain, irfft.istft_ola_fft_plain,
              kmdct.mdct_fft_plain, kmdct.imdct_ola_fft_plain,
              melfused.spec_rows_plain, melfused.mel_rows_plain,
              melfft.spec_rows_fft_plain, melfft.mel_rows_fft_plain]
    before = [p.calls for p in plains]
    _outputs(zaftpu_torch, torch.from_numpy(signal64.astype(np.float32)),
             8192)
    ran = {p.__name__: p.calls - b for p, b in zip(plains, before)}
    # stft, spectrogram, melspectrogram, mfcc and mdct frame; istft and
    # imdct overlap-add.
    assert ran.pop("frame_window_plain") == 5
    assert ran.pop("overlap_add_plain") == 2
    assert not any(ran.values()), ran


def test_melfuse_route_above_the_kernels_window():
    """The front ends take the half spectrum above 4,096 whatever
    ZAFTPU_MELFUSE says (zaftpu gates its kernels on the direct engine)."""
    for wl in (4098, 8192):
        assert melfused.route(torch.float32, wl) == "split"
    assert melfused.route(torch.float32, 4096) == "fft"
