"""zaftpu_torch.griffin_lim and the inverse real-FFT kernel's windowed store
(kernels/irfft.py: istft_ola_fft_window and its plain version) on the CPU.

griffin_lim against zaftpu's after 1, 2 and 5 iterations, on the same
seeded magnitudes (float64 within 1e-12 * max; float32 within 1e-4 * max,
as float32 rounding grows with each projection), at the FFT rule's
windows (the half store's and the windowed store's plain versions), under
ZAFTPU_FFT=matmul (the GEMM B1 and the direct inverse), at an off-rule
window and above 4,096 (the framing and OLA kernels' plain versions and
torch.fft); tests/test_griffinlim.py's three gates on the port; the
windowed store's plain version against zaftpu's composition
(full_from_half, real_ifft, the window, OLA, / wsq) and a float64 numpy
oracle, and the store with a flat window against the existing store; and
the CUDA wrapper's refusals before a launch. The
kernel itself runs on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zaftpu
import zaftpu_torch
from zaftpu.core import fft as zfft
from zaftpu.core import frame as zframe
from zaftpu.core.windows import hamming
from zaftpu.transforms.griffinlim import griffin_lim as zgriffin_lim
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import irfft as tirfft
from zaftpu_torch.kernels import ola as tola
from zaftpu_torch.kernels import rfft as trfft

WL, STEP = 512, 256  # tests/test_griffinlim.py's
# WL, hop: the FFT rule's windows (tests/test_griffinlim.py's and a
# quarter hop), an off-rule window (262 = 2 * 131) and one above 4,096.
CASES = [(256, 64), (512, 256), (262, 131), (8192, 2048)]


def _close(mine, ref, tol):
    mine, ref = mine.numpy(), np.asarray(ref)
    assert mine.shape == ref.shape and mine.dtype == ref.dtype
    err = float(np.abs(mine - ref).max())
    assert err <= tol * float(np.abs(ref).max()), err


def _magnitude(wl, step, seconds=0.2, dtype=np.float64):
    """|rfft bins 0..WL/2| of a seeded signal's STFT, ``(WL/2+1, T)``."""
    x = np.random.default_rng(wl + step).standard_normal(int(44100 * seconds))
    mag = np.abs(np.asarray(zaftpu.stft(x, hamming(wl), step)))
    return mag[:wl // 2 + 1].astype(dtype)


@pytest.mark.parametrize("wl,step", CASES)
@pytest.mark.parametrize("iterations", [1, 2, 5])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-4)])
def test_matches_zaftpu_iteration_by_iteration(wl, step, iterations, dtype,
                                               tol):
    mag = _magnitude(wl, step, dtype=dtype)
    win = hamming(wl).astype(dtype)
    mine = zaftpu_torch.griffin_lim(torch.from_numpy(mag), win, step,
                                    iterations=iterations)
    _close(mine, zgriffin_lim(mag, win, step, iterations=iterations), tol)


@pytest.mark.parametrize("wl,step", [(256, 64), (512, 256)])
@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_matmul_lever_matches_zaftpu(wl, step, momentum, monkeypatch):
    """ZAFTPU_FFT=matmul on both sides: the GEMM B1's plain version and the
    direct inverse GEMM here, zaftpu's direct engine there."""
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    mag = _magnitude(wl, step)
    win = hamming(wl)
    mine = zaftpu_torch.griffin_lim(torch.from_numpy(mag), win, step,
                                    iterations=3, momentum=momentum)
    _close(mine, zgriffin_lim(mag, win, step, iterations=3,
                              momentum=momentum), 1e-12)


def test_rule_windows_take_the_two_fft_stores():
    """At a rule window each iteration runs the half store's and the
    windowed store's plain versions once (and the final synthesis once
    more); the envelope is one OLA."""
    counters = (trfft.frames_rfft_fft_plain, tirfft.istft_ola_fft_window_plain,
                tola.overlap_add_plain)
    before = [c.calls for c in counters]
    zaftpu_torch.griffin_lim(torch.from_numpy(_magnitude(512, 128)),
                             hamming(512), 128, iterations=4)
    assert [c.calls - b for c, b in zip(counters, before)] == [4, 5, 1]


def spectral_error(target_mag, signal, window, step):
    """tests/test_griffinlim.py's measure on the port's stft."""
    wl = window.shape[0]
    spec = zaftpu_torch.stft(signal, window, step)[:wl // 2 + 1].abs()
    t = min(spec.shape[1], target_mag.shape[1])
    num = torch.linalg.norm(spec[:, :t] - target_mag[:, :t])
    return float(num / torch.linalg.norm(target_mag[:, :t]))


def test_reconstruction_converges(golden):
    sig = torch.from_numpy(golden["signal"][:44100].astype(np.float32))
    win = hamming(WL).astype(np.float32)
    mag = zaftpu_torch.stft(sig, win, STEP)[:WL // 2 + 1].abs()
    few = zaftpu_torch.griffin_lim(mag, win, STEP, iterations=2)
    many = zaftpu_torch.griffin_lim(mag, win, STEP, iterations=40)
    err_few = spectral_error(mag, few, win, STEP)
    err_many = spectral_error(mag, many, win, STEP)
    assert err_many < err_few
    assert err_many < 0.1


def test_output_shape_and_dtype(golden):
    sig = torch.from_numpy(golden["signal"][:22050])
    win = hamming(WL)
    spec = zaftpu_torch.stft(sig, win, STEP)
    out = zaftpu_torch.griffin_lim(spec.abs()[:WL // 2 + 1], win, STEP,
                                   iterations=1)
    ref = zaftpu_torch.istft(spec, win, STEP)
    assert out.shape == ref.shape
    assert out.dtype == torch.float64


def test_exact_phase_fixed_point(golden):
    sig = torch.from_numpy(golden["signal"][:44100].astype(np.float32))
    win = hamming(WL).astype(np.float32)
    mag = zaftpu_torch.stft(sig, win, STEP)[:WL // 2 + 1].abs()
    out = zaftpu_torch.griffin_lim(mag, win, STEP, iterations=60)
    assert spectral_error(mag, out, win, STEP) < 0.08


def test_refuses_a_magnitude_of_the_wrong_shape():
    win = hamming(WL)
    with pytest.raises(ValueError, match="257 bins"):
        zaftpu_torch.griffin_lim(torch.ones(256, 9, dtype=torch.float64),
                                 win, STEP)
    with pytest.raises(ValueError, match="number_times"):
        zaftpu_torch.griffin_lim(torch.ones(257, dtype=torch.float64), win,
                                 STEP)


# WL, hop, T, leading axes: a hop that divides WL, one that does not, odd
# prime passes (2 * 127), one and two frames, batched.
STORE_CASES = [(256, 64, 11, ()), (400, 160, 9, (2,)), (512, 100, 7, (3,)),
               (254, 127, 5, ()), (1200, 300, 2, ()), (2048, 512, 1, (2,))]


def _store_inputs(wl, step, t, lead, dtype):
    rng = np.random.default_rng(wl * 7 + t)
    s = rng.standard_normal((2, *lead, t, wl // 2 + 1)).astype(dtype)
    win = hamming(wl).astype(dtype)
    wsq = np.maximum(np.asarray(zframe.overlap_add(
        jnp.tile(win * win, (t, 1)), step)), 1e-12).astype(dtype)
    return s, win, wsq


@pytest.mark.parametrize("wl,step,t,lead", STORE_CASES)
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 2e-6)])
def test_window_store_plain_matches_zaftpus_composition(wl, step, t, lead,
                                                        dtype, tol):
    """overlap_add(real_ifft(full_from_half(S)) * win) / wsq, per row, as
    zaftpu's synthesize computes it (griffinlim.py:40-43)."""
    s, win, wsq = _store_inputs(wl, step, t, lead, dtype)
    mine = tirfft.istft_ola_fft_window_plain(
        torch.complex(torch.from_numpy(s[0]), torch.from_numpy(s[1])), wl,
        step, torch.from_numpy(win), torch.from_numpy(wsq))
    half = jnp.asarray(s[0] + 1j * s[1])
    frames = zfft.real_ifft(zfft.full_from_half(half, wl)) * win
    ref = zframe.overlap_add(frames, step) / wsq
    _close(mine, ref, tol)
    oracle = np.zeros((*lead, (t - 1) * step + wl))
    inv = np.fft.irfft(s[0].astype(np.float64) + 1j * s[1], wl) * win
    for i in range(t):
        oracle[..., i * step:i * step + wl] += inv[..., i, :]
    _close(mine.double(), oracle / wsq, 10 * tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_window_store_with_a_flat_window_is_the_existing_store(dtype):
    """A ones window and a ones envelope leave the existing store's plain
    version, bit for bit: the half spectrum's planes are the fold of its
    conjugate mirror."""
    wl, step, t = 400, 160, 9
    s = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, t, wl // 2 + 1))).to(dtype)
    ones = torch.ones(wl, dtype=dtype)
    flat = tirfft.istft_ola_fft_window_plain(
        torch.complex(s[0], s[1]), wl, step, ones,
        torch.ones((t - 1) * step + wl, dtype=dtype))
    assert torch.equal(flat, tirfft.istft_ola_fft_plain(s[0], s[1], wl, step,
                                                        1.0))


def test_window_store_no_frames():
    out = tirfft.istft_ola_fft_window_plain(
        torch.zeros(0, 129, dtype=torch.complex64), 256, 64,
        torch.ones(256), torch.full((192,), 2.0))
    assert out.shape == (192,) and not out.any()


def _bad_window_launch(case):
    wl, step, t = 256, 64, 5
    spec = torch.zeros(t, wl // 2 + 1, dtype=torch.complex64)
    win, wsq = torch.ones(wl), torch.ones((t - 1) * step + wl)
    args = {"f64": (spec.to(torch.complex128), wl, step, win, wsq),
            "step": (spec, wl, wl + 1, win, wsq),
            "window": (spec, wl, step, win[:-1], wsq),
            "wsq": (spec, wl, step, win, wsq[:-1]),
            "planes": (spec[:, :-1], wl, step, win, wsq),
            "too_long": (torch.zeros(t, 4097, dtype=torch.complex64), 8192,
                         step, torch.ones(8192), torch.ones(8192 + 4 * step))}
    return tirfft._launch_complex("istft_ola_fft_window",
                                  *args[case][:3], 1.0, args[case][3:])


@pytest.mark.parametrize("case", ["f64", "step", "window", "wsq", "planes",
                                  "too_long"])
def test_window_store_refuses_before_launch(case, monkeypatch):
    """The CUDA half checks the dtype, hop, window, envelope, spectrum width
    and length before it touches the library: complex128 raises
    NotImplementedError, the rest ValueError; no launch is counted."""
    def no_library():
        raise AssertionError("the launch was reached")

    monkeypatch.setattr(_build, "library", no_library)
    launches = tirfft.istft_ola_fft_window.launches
    error = NotImplementedError if case == "f64" else ValueError
    with pytest.raises(error):
        _bad_window_launch(case)
    assert tirfft.istft_ola_fft_window.launches == launches
