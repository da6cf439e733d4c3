"""The inverse real-FFT + overlap-add kernel's plain version
(zaftpu_torch.kernels.irfft) against zaftpu's synthesis, against a float64
numpy irfft and overlap-add, the CPU istft through it on both dials
against the goldens and zaftpu, the shape rule that sends both dials' ISTFT
synthesis to it and what keeps B4 and its split4 twin, and the checks its
CUDA wrapper makes before a launch.

zaftpu's reference is what it runs on these shapes: its fused synthesis
kernel ``istft_ola`` in interpret mode where the kernel takes the hop (a
divisor of WL with at least two chunks), else its split path, the folded
inverse DFT ``direct_real_ifft_folded`` and ``overlap_add``. The CUDA
kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it against this plain version there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zaftpu
import zaftpu_torch
from conftest import snr_db
from zaftpu.core import fft as zfft
from zaftpu.core import frame as zframe
from zaftpu.core.windows import hamming
from zaftpu.pallas import synth as zsynth
from zaftpu_torch.kernels import irfft as tirfft
from zaftpu_torch.kernels import synth as tsynth

SCALE = 0.7310586
# WL, hop, T, leading axes: a hop that does not divide WL (400 / 160), T = 1,
# mixed radices (24: 4, 3; 400: 4, 2, 5, 5; 882: 3, 3, 7, 7; 1764: 2, 3, 3,
# 7, 7; 3000: 4, 3, 5, 5, 5), primes above 7 (220: 2, 5, 11; 254: 127;
# 1102: 19, 29; 2662: 11, 11, 11; 2822: 17, 83) and batches.
ZAFTPU_CASES = [(16, 8, 11, (2,)), (16, 4, 1, ()), (24, 6, 11, (2,)),
                (400, 160, 11, (2,)), (400, 200, 1, ()), (882, 441, 11, ()),
                (1764, 882, 7, (2,)), (2048, 1024, 5, ()),
                (2048, 512, 1, (2,)), (3000, 1000, 4, ()),
                (220, 110, 11, (2,)), (254, 100, 7, ()), (1102, 551, 7, ()),
                (2662, 1331, 3, ()), (2822, 1411, 4, (2,))]
# The generic odd-prime passes: 220, 254, 286 (11, 13), 1102, 2032 (4, 2,
# 127), 2662 and 2822.
PRIME_WINDOWS = [220, 254, 286, 1102, 2032, 2662, 2822]
WINDOWS = [16, 64, 256, 2048, 4096, 24, 400, 882, 1764, 3000] + PRIME_WINDOWS
HOPS = ["1", "quarter", "half", "whole", "non-divisor"]
T = 11


def _hop(wl: int, kind: str) -> int:
    return {"1": 1, "quarter": wl // 4, "half": wl // 2, "whole": wl,
            "non-divisor": wl // 3 + 1}[kind]


def _planes(lead, wl, t, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, *lead, t, wl // 2 + 1)).astype(dtype)


def _zaftpu_ola(h_re, h_im, wl, step):
    """zaftpu's synthesis of one row's planes ``(T, F)`` for this hop."""
    if wl % step == 0 and wl // step >= 2:
        return np.asarray(zsynth.istft_ola(jnp.asarray(h_re),
                                           jnp.asarray(h_im), wl, step,
                                           SCALE, interpret=True))
    frames = zfft.direct_real_ifft_folded(jnp.asarray(h_re),
                                          jnp.asarray(h_im), wl, SCALE)
    return np.asarray(zframe.overlap_add(frames, step))


def _oracle(h, wl, step, scale=SCALE):
    """float64 numpy irfft of each row times ``scale``, overlap-added frame
    by frame in descending order (c ascending)."""
    frames = np.fft.irfft(h[0].astype(np.float64)
                          + 1j * h[1].astype(np.float64), wl) * scale
    *lead, t, _ = frames.shape
    out = np.zeros((*lead, (t - 1) * step + wl))
    for i in reversed(range(t)):
        out[..., i * step:i * step + wl] += frames[..., i, :]
    return out


@pytest.mark.parametrize("wl,step,t,lead", ZAFTPU_CASES)
def test_plain_matches_zaftpu_f32(wl, step, t, lead, monkeypatch):
    """float32: within 2e-6 of max of zaftpu's synthesis (its float32 GEMM
    rounds to about 1e-6 of max at these shapes, the FFT to about 2e-7)."""
    monkeypatch.delenv("ZAFTPU_PRECISION", raising=False)
    jax.clear_caches()
    h = _planes(lead, wl, t, wl + step + t)
    rows = h.reshape(2, -1, t, wl // 2 + 1)
    ref = np.stack([_zaftpu_ola(rows[0, i], rows[1, i], wl, step)
                    for i in range(rows.shape[1])]).reshape(*lead, -1)
    calls = tirfft.istft_ola_fft_plain.calls
    mine = tsynth.istft_ola(torch.from_numpy(h[0]), torch.from_numpy(h[1]),
                            wl, step, SCALE)
    assert tirfft.istft_ola_fft_plain.calls == calls + 1
    assert mine.dtype == torch.float32
    assert mine.shape == ref.shape == (*lead, (t - 1) * step + wl)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("wl", WINDOWS)
def test_plain_matches_numpy_irfft_f64(wl, hop):
    """float64 (the oracle mode), leading axes (2, 3): within 1e-13 of max
    of numpy's irfft and a c-ascending overlap-add."""
    step = _hop(wl, hop)
    h = _planes((2, 3), wl, T, wl * step, np.float64)
    mine = tirfft.istft_ola_fft(torch.from_numpy(h[0]),
                                torch.from_numpy(h[1]), wl, step, SCALE)
    ref = _oracle(h, wl, step)
    assert mine.shape == ref.shape and mine.dtype == torch.float64
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=1e-13 * np.abs(ref).max())


def test_imaginary_dc_and_nyquist_are_not_read():
    """An inverse real FFT ignores the imaginary parts of DC and Nyquist, as
    numpy's irfft and B4's sin operator rows do."""
    wl, step = 512, 128
    h = _planes((), wl, 9, 5, np.float64)
    moved = h.copy()
    moved[1, :, 0] += 3.0
    moved[1, :, -1] -= 2.0
    a = tirfft.istft_ola_fft_plain(*torch.from_numpy(h), wl, step, 1.0)
    b = tirfft.istft_ola_fft_plain(*torch.from_numpy(moved), wl, step, 1.0)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dial", ["highest", "split4"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cpu_istft_matches_zaftpu_and_the_goldens(golden, signal,
                                                  hamming_window, dial, dtype,
                                                  monkeypatch):
    """istft at WL 2048 on either dial runs the fused fold's plain version
    (the Hermitian fold, then the inverse FFT's arithmetic, one call):
    within 1e-12 (float64) or 2e-6 of max (float32) of the reference golden
    and of zaftpu.istft on the same spectrum, whose engine is its native
    FFT off the TPU."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    jax.clear_caches()
    spec = golden["stft"].astype(np.complex128 if dtype == np.float64
                                 else np.complex64)
    win = hamming_window.astype(dtype)
    calls = _synth_calls()
    mine = zaftpu_torch.istft(torch.from_numpy(spec), win, 1024).numpy()
    assert _synth_calls() == (calls[0], calls[1], calls[2], calls[3] + 1)
    assert mine.dtype == dtype
    ref = np.asarray(zaftpu.istft(spec, win, 1024))
    atol = (1e-12 if dtype == np.float64
            else 2e-6 * np.abs(golden["istft"]).max())
    np.testing.assert_allclose(mine, golden["istft"], rtol=0, atol=atol)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=atol)
    if dtype == np.float32:
        assert snr_db(signal, mine) > 125.0
    jax.clear_caches()


def _synth_calls():
    return (tirfft.istft_ola_fft_plain.calls, tsynth.istft_ola_plain.calls,
            tsynth.istft_ola_split4_plain.calls,
            tirfft.istft_ola_fft_full_plain.calls)


@pytest.mark.parametrize("wl,lever,ops,want", [
    (2048, None, False, "fft"), (1764, "native", False, "fft"),
    (1102, None, False, "fft"), (262, None, False, "fft"),
    (2048, "matmul", False, "gemm"), (2048, None, True, "gemm"),
    (400, "auto", False, "fft"), (2822, None, False, "fft"),
    (262, "matmul", False, "gemm"), (441, None, False, "fft"),
    (15, None, False, "gemm")])
@pytest.mark.parametrize("dial", ["highest", "split4"])
def test_shape_rule_through_plain_calls(wl, lever, ops, want, dial,
                                        monkeypatch):
    """istft_ola takes the inverse FFT's plain version at every window from
    16 to 4,096 (WL 1102 = 2 * 19 * 29 and 2822 = 2 * 17 * 83 through the
    odd-prime passes, 262 = 2 * 131 by Bluestein, 441 odd), on both dials;
    below 16, under ZAFTPU_FFT=matmul and with an explicit operator B4's
    plain version (B4-s4's under split4), once. All agree with the float64
    oracle."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    if lever is None:
        monkeypatch.delenv("ZAFTPU_FFT", raising=False)
    else:
        monkeypatch.setenv("ZAFTPU_FFT", lever)
    step, t = wl // 2, 5
    h = _planes((), wl, t, wl)
    op = (tsynth.istft_ops(wl, SCALE, torch.float32, "cpu") if ops
          else None)
    before = _synth_calls()
    out = tsynth.istft_ola(torch.from_numpy(h[0]), torch.from_numpy(h[1]),
                           wl, step, SCALE, op)
    gemm = (0, 0, 1, 0) if dial == "split4" else (0, 1, 0, 0)
    assert _synth_calls() == tuple(b + d for b, d in zip(
        before, (1, 0, 0, 0) if want == "fft" else gemm))
    ref = _oracle(h, wl, step)
    tol = 1e-4 if want == "gemm" and dial == "split4" else 2e-6
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_synth_lever_off_keeps_the_split_path(signal, hamming_window,
                                              monkeypatch):
    """ZAFTPU_SYNTH=0 keeps its meaning: the inverse GEMM and the OLA, no
    synthesis kernel of either kind."""
    monkeypatch.setenv("ZAFTPU_SYNTH", "0")
    spec = zaftpu_torch.stft(torch.from_numpy(signal), hamming_window, 1024)
    before = _synth_calls()
    zaftpu_torch.istft(spec, hamming_window, 1024)
    assert _synth_calls() == before


def _bad_launch(case):
    """Call the kernel's checking half with one bad argument."""
    wl, step, t = 256, 128, 9
    h = torch.zeros(t, wl // 2 + 1)
    calls = {
        "f64": lambda: tirfft._launch(h.double(), h.double(), wl, step, 1.0),
        # The windowed store keeps the static path's windows; the inverse
        # takes every other from 16 to 4,096 (an odd one below 16 fails).
        "prime_above_7": lambda: tirfft._launch_complex(
            "istft_ola_fft_window",
            torch.zeros(t, 132, dtype=torch.complex64), 262, 131, 1.0,
            (torch.zeros(262), torch.ones(8 * 131 + 262))),
        "odd": lambda: tirfft._launch(torch.zeros(t, 8), torch.zeros(t, 8),
                                      15, 7, 1.0),
        "too_long": lambda: tirfft._launch(
            torch.zeros(2, 4097), torch.zeros(2, 4097), 8192, 4096, 1.0),
        "step_0": lambda: tirfft._launch(h, h, wl, 0, 1.0),
        "step_past_n": lambda: tirfft._launch(h, h, wl, wl + 1, 1.0),
        "planes": lambda: tirfft._launch(h, h[:-1], wl, step, 1.0),
        "width": lambda: tirfft._launch(h[:, :-1], h[:, :-1], wl, step, 1.0),
    }
    return calls[case]()


@pytest.mark.parametrize("case", ["f64", "prime_above_7", "odd", "too_long",
                                  "step_0", "step_past_n", "planes",
                                  "width"])
def test_wrapper_refuses_before_launch(case, monkeypatch):
    """The CUDA half of the wrapper checks dtype, window, hop and planes
    before it touches the library: non-float32 raises NotImplementedError,
    the rest ValueError."""
    from zaftpu_torch.kernels import _build

    def no_library():
        raise AssertionError("the launch was reached")

    monkeypatch.setattr(_build, "library", no_library)
    launches = tirfft.istft_ola_fft.launches
    error = NotImplementedError if case == "f64" else ValueError
    with pytest.raises(error):
        _bad_launch(case)
    assert tirfft.istft_ola_fft.launches == launches


@pytest.mark.parametrize("wl", PRIME_WINDOWS)
def test_prime_windows_f32_match_numpy_irfft(wl):
    """float32 through the generic odd-prime passes, two batch rows, a hop
    that does not divide WL: within 1e-6 of max of numpy's float64 irfft
    and overlap-add."""
    step = _hop(wl, "non-divisor")
    h = _planes((2,), wl, T, wl + 11)
    mine = tirfft.istft_ola_fft(torch.from_numpy(h[0]),
                                torch.from_numpy(h[1]), wl, step, SCALE)
    ref = _oracle(h, wl, step)
    assert mine.dtype == torch.float32
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
