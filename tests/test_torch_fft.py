"""The real-FFT analysis kernel's plain version (zaftpu_torch.kernels.rfft)
against zaftpu's half-spectrum analysis, against a float64 numpy rfft, its
twiddle table and mixed-radix pass plans, the shape rule that sends both
dials to it and the ZAFTPU_FFT lever that turns the rule off, and a CPU
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

import zaftpu
import zaftpu_torch
from conftest import snr_db
from zaftpu.core import fft as zfft
from zaftpu.core import frame as zframe
from zaftpu.core.windows import hamming
from zaftpu.pallas import fused as zfused
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import irfft as tirfft
from zaftpu_torch.kernels import rfft as trfft

# Powers of two, and mixed radices: 24 (m = 12: 4, 3), 400 (m = 200: 4, 2,
# 5, 5), 882 (odd m = 441: 3, 3, 7, 7), 1764 (m = 882: 2, 3, 3, 7, 7) and
# 3000 (m = 1500: 4, 3, 5, 5, 5; one frame per block on the card).
# Primes above 7 (the generic odd-prime pass): 220 (m = 110: 2, 5, 11), 254
# (127), 286 (11, 13), 1102 (19, 29: the 25-ms window at 44.1 kHz), 2032 (4,
# 2, 127), 2662 (11, 11, 11) and 2822 (17, 83: 64 ms at 44.1 kHz).
PRIME_WINDOWS = [220, 254, 286, 1102, 2032, 2662, 2822]
WINDOWS = [16, 64, 256, 2048, 4096, 24, 400, 882, 1764, 3000] + PRIME_WINDOWS
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


@pytest.mark.parametrize("m,want", [
    (8, (4, 2)), (16, (4, 4)), (32, (4, 4, 2)), (1024, (4,) * 5),
    (2048, (4,) * 5 + (2,)), (12, (4, 3)), (9, (3, 3)), (200, (4, 2, 5, 5)),
    (441, (3, 3, 7, 7)), (882, (2, 3, 3, 7, 7)), (1500, (4, 3, 5, 5, 5)),
    (2016, (4, 4, 2, 3, 3, 7)), (2025, (3, 3, 3, 3, 5, 5)),
    (551, (19, 29)), (110, (2, 5, 11)), (127, (127,)), (143, (11, 13)),
    (1016, (4, 2, 127)), (1331, (11, 11, 11)), (1411, (17, 83)),
    (1386, (2, 3, 3, 7, 11))])
def test_radices(m, want):
    """Radix 4 while it fits in the power-of-two part, one radix 2 when its
    log2 is odd, then the 3s, 5s and 7s, then the primes above 7 ascending:
    the passes multiply to m."""
    assert trfft.radices(m) == want
    assert int(np.prod(want)) == m


@pytest.mark.parametrize("log_m", range(3, 12))
def test_radices_of_a_power_of_two_keep_the_radix_4_plan(log_m):
    """Every power-of-two half length keeps the plan the kernel ran before
    the odd radices: radix 4 while it fits, then one radix 2."""
    assert trfft.radices(1 << log_m) == (4,) * (log_m // 2) + (2,) * (log_m % 2)


def test_radices_refuse_a_prime_above_7():
    """A prime factor above 127 is refused: 131 (WL 262), 1031 (WL 2062)
    and 2039 (WL 4078); 551 = 19 * 29 (WL 1102) takes two prime passes."""
    assert trfft.radices(551) == (19, 29)
    for m in (131, 1031, 2039, 2 * 131):
        with pytest.raises(ValueError, match="above 127"):
            trfft.radices(m)


@pytest.mark.parametrize("wl,fft", [(8, False), (16, True), (100, True),
                                    (255, False), (256, True), (2048, True),
                                    (3000, True), (4096, True), (1764, True),
                                    (1102, True), (38, True), (262, False),
                                    (2062, False)])
def test_shape_rule_through_plain_calls(wl, fft, monkeypatch):
    """frames_rfft and frames_matmul2 take the FFT's plain version at every
    window in [16, 4096] with no operator, on both dials: rfft.applies
    (the full store's rule: an even window whose half has no prime factor
    above 127) and beyond it (255, 262 = 2 * 131, 2062 = 2 * 1031:
    rfft_any); a window below 16 keeps the GEMM plain versions (the split4
    twin's under split4), and an explicit operator the exact GEMM's."""
    monkeypatch.delenv("ZAFTPU_PRECISION", raising=False)
    assert trfft.applies(wl) is fft
    fft = trfft.half_applies(wl)
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
    assert calls() == tuple(b + d for b, d in zip(
        before, (1, 0, 0, 0, 0) if fft else (0, 0, 0, 0, 1)))


def _largest_prime_factor(m):
    largest, p = 1, 2
    while m > 1:
        while m % p == 0:
            m //= p
            largest = p
        p += 1
    return largest


def test_shape_rule_bounds():
    """Exactly the even N in [16, 4096] whose half has no prime factor
    above 127: 1,263 lengths (183 of them 7-smooth), every power of two
    among them, the audio front ends' 25-ms, 40-ms and 10-ms windows at 16
    kHz, 44.1 kHz and 48 kHz, and 10 ms at 22.05 kHz (220) and 64 ms at
    44.1 kHz (2822 = 2 * 17 * 83)."""
    want = [n for n in range(16, 4097, 2)
            if _largest_prime_factor(n // 2) <= 127]
    assert [n for n in range(1, 9000) if trfft.applies(n)] == want
    assert [n for n in range(1, 9000) if trfft.fits(n)] == want
    assert len(want) == 1263
    assert sum(_largest_prime_factor(n // 2) <= 7 for n in want) == 183
    assert {16, 32, 64, 128, 256, 512, 1024, 2048, 4096} <= set(want)
    assert {320, 400, 480, 882, 960, 1200, 1764, 2400, 3000} <= set(want)
    assert {220, 1102, 2032, 2662, 2822} <= set(want)
    assert not {8, 255, 262, 1323, 2062, 4078, 4098, 8192} & set(want)
    assert not trfft.applies(2048, ops=torch.zeros(1))


@pytest.mark.parametrize("mode,fft", [(None, True), ("auto", True),
                                      ("native", True), ("matmul", False)])
@pytest.mark.parametrize("dial", ["highest", "split4"])
def test_fft_lever_matmul_turns_the_rule_off(mode, fft, dial, monkeypatch):
    """ZAFTPU_FFT, zaftpu's engine lever: matmul sends a window the rule
    covers (WL 1764) to the GEMM, on the exact dial and, as its twin,
    under split4; auto (the default) and native follow the rule. fits,
    the CUDA entry's set, does not move."""
    if mode is None:
        monkeypatch.delenv("ZAFTPU_FFT", raising=False)
    else:
        monkeypatch.setenv("ZAFTPU_FFT", mode)
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    wl, step, t = 1764, 882, 3
    assert trfft.applies(wl) is fft and trfft.fits(wl)
    padded = torch.from_numpy(_signal((), wl, step, t, 3))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    gemm = (tfused.frames_rfft_split4_plain if dial == "split4"
            else tfused.frames_rfft_plain)
    counters = (trfft.frames_rfft_fft_plain, gemm)
    before = tuple(c.calls for c in counters)
    half = tfused.frames_rfft(padded, win, wl, step, t)
    assert tuple(c.calls for c in counters) == tuple(
        b + d for b, d in zip(before, (1, 0) if fft else (0, 1)))
    oracle = _oracle(padded.numpy(), win.numpy(), wl, step, t)
    np.testing.assert_allclose(half.numpy(), oracle, rtol=0,
                               atol=1e-5 * np.abs(oracle).max())


def test_stft_takes_the_fft_and_fullspec_keeps_the_gemm(monkeypatch):
    """At a rule window the default stft and ZAFTPU_FULLSPEC=1 take the FFT
    kernel's full store, ZAFTPU_FULLSPEC=0 its half store and the mirror;
    ZAFTPU_FULLSPEC=1 with ZAFTPU_FFT=matmul keeps the GEMM B3. All four
    spectra are equal."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(9000))
    counters = (trfft.frames_rfft_full_fft_plain, trfft.frames_rfft_fft_plain,
                tfused.frames_rfft_full_plain)
    specs = []
    for levers, took in (({}, 0), ({"ZAFTPU_FULLSPEC": "1"}, 0),
                         ({"ZAFTPU_FULLSPEC": "0"}, 1),
                         ({"ZAFTPU_FULLSPEC": "1", "ZAFTPU_FFT": "matmul"},
                          2)):
        for name, value in levers.items():
            monkeypatch.setenv(name, value)
        before = [c.calls for c in counters]
        specs.append(zaftpu_torch.stft(x, hamming(512), 128))
        before[took] += 1
        assert [c.calls for c in counters] == before, levers
        for name in levers:
            monkeypatch.delenv(name)
    assert torch.equal(specs[0], specs[1]) and torch.equal(specs[0], specs[2])
    torch.testing.assert_close(specs[3], specs[0], rtol=0, atol=1e-12)


def test_cpu_f32_round_trip_above_120db(signal, hamming_window):
    """The exact-dial gate: float32 stft (the FFT full store's plain version
    at WL 2048) then istft reads at least 120 dB."""
    x32 = signal.astype(np.float32)
    calls = trfft.frames_rfft_full_fft_plain.calls
    spec = zaftpu_torch.stft(torch.from_numpy(x32), hamming_window, 1024)
    assert trfft.frames_rfft_full_fft_plain.calls == calls + 1
    rec = zaftpu_torch.istft(spec, hamming_window, 1024)
    assert snr_db(x32.astype(np.float64), rec.numpy().astype(np.float64)) \
        >= 120.0


def _bad_fft_launch(case):
    """Call the FFT kernel's checking half with one bad argument."""
    wl, step, t = 256, 128, 9
    padded = torch.zeros(t * step + wl - step)
    win = torch.zeros(wl)
    calls = {
        "f64": lambda: trfft._launch("frames_rfft_fft", "half",
                                     padded.double(), win, wl, step, t),
        "step": lambda: trfft._launch("frames_rfft_fft", "half", padded, win,
                                      wl, wl + 1, t),
        "window": lambda: trfft._launch("frames_rfft_fft", "half", padded,
                                        win[:-1], wl, step, t),
        "short": lambda: trfft._launch("frames_matmul2_fft", "planes",
                                       padded[:-1], win, wl, step, t),
        # Every store takes every window from 16 to 4,096: the full store
        # refuses one below 16 (15, 13) as it refuses one above.
        "not_pow2": lambda: trfft._launch("frames_rfft_full_fft", "full",
                                          torch.zeros(8 * 7 + 15),
                                          torch.zeros(15), 15, 7, 9),
        "prime_above_7": lambda: trfft._launch(
            "frames_rfft_full_fft", "full", torch.zeros(8 * 6 + 13),
            torch.zeros(13), 13, 6, 9),
        "too_long": lambda: trfft._launch(
            "frames_rfft_fft", "half", torch.zeros(8192 * 2),
            torch.zeros(8192), 8192, 4096, 2),
        "full_short": lambda: trfft._launch("frames_rfft_full_fft", "full",
                                            padded[:-1], win, wl, step, t),
    }
    return calls[case]()


@pytest.mark.parametrize("case", ["f64", "step", "window", "short",
                                  "not_pow2", "prime_above_7", "too_long",
                                  "full_short"])
def test_fft_wrapper_refuses_before_launch(case, monkeypatch):
    """The CUDA half of the wrapper checks dtype, hop, window, length and
    the kernel's set of lengths before it touches the library: non-float32
    raises NotImplementedError, the rest ValueError."""
    from zaftpu_torch.kernels import _build

    def no_library():
        raise AssertionError("the launch was reached")

    monkeypatch.setattr(_build, "library", no_library)
    wrappers = (trfft.frames_rfft_fft, trfft.frames_matmul2_fft,
                trfft.frames_rfft_full_fft)
    launches = [w.launches for w in wrappers]
    error = NotImplementedError if case == "f64" else ValueError
    with pytest.raises(error):
        _bad_fft_launch(case)
    assert [w.launches for w in wrappers] == launches


@pytest.mark.parametrize("wl", PRIME_WINDOWS)
def test_prime_windows_f32_match_numpy_rfft(wl):
    """float32 through the generic odd-prime passes, two batch rows, a hop
    that does not divide WL: within 1e-6 of max of numpy's float64 rfft
    (the FFT's float32 rounding reads 1.3-2.5e-7 of max here)."""
    step = _hop(wl, "non-divisor")
    padded = _signal((2,), wl, step, T, wl + 7)
    win = hamming(wl).astype(np.float32)
    mine = trfft.frames_rfft_fft(torch.from_numpy(padded),
                                 torch.from_numpy(win), wl, step, T)
    ref = _oracle(padded, win, wl, step, T)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("wl", PRIME_WINDOWS)
def test_prime_windows_stft_istft_match_zaftpu(wl, monkeypatch):
    """The public float32 stft -> istft at a window whose half has a prime
    factor above 7, half overlap: the FFT's full store and the fused
    fold's (the Hermitian fold read in the inverse FFT's load) plain
    versions, once each; the spectrum and the signal within
    1e-5 of max of zaftpu.stft and zaftpu.istft on the same input
    (tests/test_torch_stft.py's gate), and a round trip of at least 120
    dB."""
    monkeypatch.delenv("ZAFTPU_PRECISION", raising=False)
    step = wl // 2
    x = np.random.default_rng(wl).standard_normal(12 * wl).astype(
        np.float32)
    win = hamming(wl).astype(np.float32)
    counters = (trfft.frames_rfft_full_fft_plain,
                tirfft.istft_ola_fft_full_plain, tirfft.istft_ola_fft_plain)
    before = [c.calls for c in counters]
    spec = zaftpu_torch.stft(torch.from_numpy(x), win, step)
    rec = zaftpu_torch.istft(spec, win, step)
    assert [c.calls for c in counters] == [before[0] + 1, before[1] + 1,
                                           before[2]]
    ref = np.asarray(zaftpu.stft(x, win, step))
    ref_rec = np.asarray(zaftpu.istft(ref, win, step))
    assert spec.dtype == torch.complex64 and tuple(spec.shape) == ref.shape
    np.testing.assert_allclose(spec.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(rec.numpy(), ref_rec, rtol=0,
                               atol=1e-5 * np.abs(ref_rec).max())
    assert snr_db(x.astype(np.float64),
                  rec.numpy().astype(np.float64)) >= 120.0
