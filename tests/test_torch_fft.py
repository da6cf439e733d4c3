"""The real-FFT analysis kernel's plain version (zaftpu_torch.kernels.rfft)
against zaftpu's half-spectrum analysis, against a float64 numpy rfft, its
twiddle table, the shape rule that sends the exact dial to it, and a CPU
float32 stft -> istft round trip through it.

zaftpu's reference is what its own dispatch runs on these shapes: the
fused Pallas kernel ``frames_rfft`` in interpret mode where it takes the
hop (a divisor of WL; hop 1 only up to WL 64, which interpret mode runs in
seconds), else its XLA framing and the DFT GEMM ``direct_rfft``. The CUDA
kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it against this plain version there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zaftpu_torch
from conftest import snr_db
from zaftpu.core import fft as zfft
from zaftpu.core import frame as zframe
from zaftpu.core.windows import hamming
from zaftpu.pallas import fused as zfused
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import rfft as trfft

WINDOWS = [16, 64, 256, 2048, 4096]
HOPS = ["1", "quarter", "half", "whole", "non-divisor"]
T = 11  # not a multiple of any block


def _hop(wl: int, kind: str) -> int:
    return {"1": 1, "quarter": wl // 4, "half": wl // 2, "whole": wl,
            "non-divisor": wl // 3 + 1}[kind]


def _signal(lead, wl, step, t, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((*lead, (t - 1) * step + wl)).astype(dtype)


def _oracle(padded, win, wl, step, t):
    """float64 numpy rfft of the windowed frames."""
    frames = np.lib.stride_tricks.sliding_window_view(
        padded.astype(np.float64), wl, axis=-1)[..., ::step, :][..., :t, :]
    return np.fft.rfft(frames * win.astype(np.float64), axis=-1)


def _zaftpu_half(row, win, wl, step, t):
    """zaftpu's half spectrum of one padded row, as its dispatch computes
    it for this hop."""
    if wl % step == 0 and (step > 1 or wl <= 64):
        return np.asarray(zfused.frames_rfft(
            jnp.asarray(row), jnp.asarray(win), wl, step, t, interpret=True))
    frames = zframe.extract_frames(jnp.asarray(row), wl, step, t)
    return np.asarray(zfft.direct_rfft(frames * jnp.asarray(win)))


@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("wl", WINDOWS)
def test_fft_plain_matches_zaftpu_f32(wl, hop):
    """float32, two batch rows, ragged T: within 2e-6 of max (the float32
    GEMM's rounding on zaftpu's side is up to 1e-6 of max at these shapes,
    the FFT's about 2e-7)."""
    step = _hop(wl, hop)
    padded = _signal((2,), wl, step, T, wl + step)
    win = hamming(wl).astype(np.float32)
    ref = np.stack([_zaftpu_half(row, win, wl, step, T) for row in padded])
    calls = trfft.frames_rfft_fft_plain.calls
    mine = tfused.frames_rfft(torch.from_numpy(padded), torch.from_numpy(win),
                              wl, step, T)
    assert trfft.frames_rfft_fft_plain.calls == calls + 1
    assert mine.shape == ref.shape == (2, T, wl // 2 + 1)
    assert mine.dtype == torch.complex64
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("wl", WINDOWS)
def test_fft_plain_matches_numpy_rfft_f64(wl, hop):
    """float64 (the oracle mode), leading axes (2, 3): within 1e-13 of max
    of numpy's rfft."""
    step = _hop(wl, hop)
    padded = _signal((2, 3), wl, step, T, wl * step, np.float64)
    win = hamming(wl)
    mine = trfft.frames_rfft_fft(torch.from_numpy(padded),
                                 torch.from_numpy(win), wl, step, T)
    ref = _oracle(padded, win, wl, step, T)
    assert mine.shape == ref.shape and mine.dtype == torch.complex128
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=1e-13 * np.abs(ref).max())


@pytest.mark.parametrize("wl", WINDOWS)
def test_planes_store_equals_half_store(wl):
    padded = torch.from_numpy(_signal((3,), wl, wl // 4, T, 1))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    half = trfft.frames_rfft_fft(padded, win, wl, wl // 4, T)
    re, im = trfft.frames_matmul2_fft(padded, win, wl, wl // 4, T)
    assert re.dtype == im.dtype == torch.float32
    assert torch.equal(torch.complex(re, im), half)


@pytest.mark.parametrize("n", [16, 32, 512, 2048, 4096])
def test_twiddle_table_against_float64(n):
    """W_N^j = exp(-2 pi i j / N) computed in float64 and rounded once:
    the float32 table is the float64 one cast, each entry within half a
    float32 ulp of 1 of the exact value."""
    exact = np.exp(-2j * np.pi * np.arange(n) / n)
    t64 = trfft._twiddles(n, "float64")
    t32 = trfft._twiddles(n, "float32")
    assert t64.shape == t32.shape == (n, 2) and t32.dtype == np.float32
    np.testing.assert_allclose(t64[:, 0] + 1j * t64[:, 1], exact, rtol=0,
                               atol=4e-16)
    np.testing.assert_array_equal(t32, t64.astype(np.float32))
    assert np.abs(t32.astype(np.float64) - t64).max() <= 2.0 ** -25
    on_card = trfft.twiddles(n, torch.float32, "cpu")
    assert on_card.dtype == torch.float32
    np.testing.assert_array_equal(on_card.numpy(), t32)


@pytest.mark.parametrize("m,want", [(8, (4, 2)), (16, (4, 4)), (32, (4, 4, 2)),
                                    (1024, (4,) * 5), (2048, (4,) * 5 + (2,))])
def test_radices(m, want):
    assert trfft.radices(m) == want


@pytest.mark.parametrize("wl,fft", [(8, False), (16, True), (100, False),
                                    (255, False), (256, True), (2048, True),
                                    (3000, False), (4096, True)])
def test_shape_rule_through_plain_calls(wl, fft, monkeypatch):
    """frames_rfft and frames_matmul2 take the FFT's plain version at a
    power-of-two window in [16, 4096] and no operator; any other length,
    an explicit operator and the split4 dial keep their GEMM plain
    versions."""
    monkeypatch.delenv("ZAFTPU_PRECISION", raising=False)
    assert trfft.applies(wl) is fft
    step = max(1, wl // 2)
    padded = torch.from_numpy(_signal((), wl, step, 3, 2))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    counters = (trfft.frames_rfft_fft_plain, trfft.frames_matmul2_fft_plain,
                tfused.frames_rfft_plain, tfused.frames_matmul2_plain,
                tfused.frames_rfft_split4_plain)

    def calls():
        return tuple(c.calls for c in counters)

    before = calls()
    tfused.frames_rfft(padded, win, wl, step, 3)
    tfused.frames_matmul2(padded, win, wl, step, 3)
    assert calls() == tuple(b + d for b, d in zip(
        before, (1, 1, 0, 0, 0) if fft else (0, 0, 1, 1, 0)))
    ops = tfused.rdft_ops(wl, torch.float32, "cpu")
    before = calls()
    tfused.frames_rfft(padded, win, wl, step, 3, ops=ops)
    tfused.frames_matmul2(padded, win, wl, step, 3, ops=ops)
    assert calls() == tuple(b + d for b, d in zip(before, (0, 0, 1, 1, 0)))
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    before = calls()
    tfused.frames_rfft(padded, win, wl, step, 3)
    assert calls() == tuple(b + d for b, d in zip(before, (0, 0, 0, 0, 1)))


def test_shape_rule_bounds():
    assert [n for n in range(1, 9000) if trfft.applies(n)] == [
        16, 32, 64, 128, 256, 512, 1024, 2048, 4096]
    assert not trfft.applies(2048, ops=torch.zeros(1))


def test_stft_takes_the_fft_and_fullspec_keeps_the_gemm(monkeypatch):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(9000))
    before = (trfft.frames_rfft_fft_plain.calls,
              tfused.frames_rfft_full_plain.calls)
    zaftpu_torch.stft(x, hamming(512), 128)
    monkeypatch.setenv("ZAFTPU_FULLSPEC", "1")
    zaftpu_torch.stft(x, hamming(512), 128)
    assert (trfft.frames_rfft_fft_plain.calls,
            tfused.frames_rfft_full_plain.calls) == (before[0] + 1,
                                                     before[1] + 1)


def test_cpu_f32_round_trip_above_120db(signal, hamming_window):
    """The exact-dial gate: float32 stft (the FFT plain version at WL 2048)
    then istft reads at least 120 dB."""
    x32 = signal.astype(np.float32)
    calls = trfft.frames_rfft_fft_plain.calls
    spec = zaftpu_torch.stft(torch.from_numpy(x32), hamming_window, 1024)
    assert trfft.frames_rfft_fft_plain.calls == calls + 1
    rec = zaftpu_torch.istft(spec, hamming_window, 1024)
    assert snr_db(x32.astype(np.float64), rec.numpy().astype(np.float64)) \
        >= 120.0


def _bad_fft_launch(case):
    """Call the FFT kernel's checking half with one bad argument."""
    wl, step, t = 256, 128, 9
    padded = torch.zeros(t * step + wl - step)
    win = torch.zeros(wl)
    calls = {
        "f64": lambda: trfft._launch("frames_rfft_fft", False,
                                     padded.double(), win, wl, step, t),
        "step": lambda: trfft._launch("frames_rfft_fft", False, padded, win,
                                      wl, wl + 1, t),
        "window": lambda: trfft._launch("frames_rfft_fft", False, padded,
                                        win[:-1], wl, step, t),
        "short": lambda: trfft._launch("frames_matmul2_fft", True,
                                       padded[:-1], win, wl, step, t),
        "not_pow2": lambda: trfft._launch("frames_matmul2_fft", True,
                                          padded[:-1], win[:-1], wl - 1,
                                          step, t),
        "too_long": lambda: trfft._launch(
            "frames_rfft_fft", False, torch.zeros(8192 * 2), torch.zeros(8192),
            8192, 4096, 2),
    }
    return calls[case]()


@pytest.mark.parametrize("case", ["f64", "step", "window", "short",
                                  "not_pow2", "too_long"])
def test_fft_wrapper_refuses_before_launch(case, monkeypatch):
    """The CUDA half of the wrapper checks dtype, hop, window, length and
    the shape rule before it touches the library: non-float32 raises
    NotImplementedError, the rest ValueError."""
    from zaftpu_torch.kernels import _build

    def no_library():
        raise AssertionError("the launch was reached")

    monkeypatch.setattr(_build, "library", no_library)
    launches = (trfft.frames_rfft_fft.launches,
                trfft.frames_matmul2_fft.launches)
    error = NotImplementedError if case == "f64" else ValueError
    with pytest.raises(error):
        _bad_fft_launch(case)
    assert (trfft.frames_rfft_fft.launches,
            trfft.frames_matmul2_fft.launches) == launches
