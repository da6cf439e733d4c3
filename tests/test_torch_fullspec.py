"""The real-FFT kernel's full store (zaftpu_torch.kernels.rfft.
frames_rfft_full_fft, B3 and B3-s4 at every window from 16 to 4,096)
through its plain version, and ZAFTPU_FULLSPEC's three values.

The plain version is the half store's plain version followed by the
conjugate mirror, and the kernel equals it bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py). Here it is held against that
composition, numpy's float64 FFT and zaftpu's full-spectrum Pallas kernel
in interpret mode; then the lever: unset, ``0`` and ``1`` crossed with the
other analysis levers, both dials, a rule window and an off-rule one, each
taking the path ``kernels.fused.fullspec_enabled`` names, with the spectrum
bit-equal wherever two paths run the same analysis kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zaftpu
import zaftpu_torch
from zaftpu.core.windows import hamming
from zaftpu.pallas import fused as zfused
from zaftpu_torch.core import fft as tfft
from zaftpu_torch.kernels import framing as tframing
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import mirror as tmirror
from zaftpu_torch.kernels import rfft as trfft

# Powers of two, mixed radices (400: 4, 2, 5, 5; 882: 3, 3, 7, 7; 1764: 2,
# 3, 3, 7, 7; 3000: 4, 3, 5, 5, 5) and primes above 7 (1102: 19, 29; 2822:
# 17, 83).
WINDOWS = [16, 400, 882, 1764, 2048, 3000, 4096, 1102, 2822]
HOPS = ["1", "non-divisor", "half", "whole"]
LEADS = [(), (2, 3), (0,)]
T = 5


def _hop(wl: int, kind: str) -> int:
    return {"1": 1, "non-divisor": wl // 3 + 1, "half": wl // 2,
            "whole": wl}[kind]


def _signal(lead, wl, step, t, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((*lead, (t - 1) * step + wl)).astype(dtype)


def _np(x):
    return x.detach().cpu().numpy()


@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("wl", WINDOWS)
def test_full_plain_is_half_plain_and_mirror(wl, hop, lead):
    step = _hop(wl, hop)
    padded = torch.from_numpy(_signal(lead, wl, step, T, wl + step))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    calls = trfft.frames_rfft_full_fft_plain.calls
    full = trfft.frames_rfft_full_fft(padded, win, wl, step, T)
    assert trfft.frames_rfft_full_fft_plain.calls == calls + 1
    assert full.shape == (*lead, T, wl) and full.dtype == torch.complex64
    half = trfft.frames_rfft_fft_plain(padded, win, wl, step, T)
    assert torch.equal(full, tfft.conjugate_mirror(half, wl))


@pytest.mark.parametrize("wl", WINDOWS)
def test_full_plain_matches_numpy_fft_f64(wl):
    """float64, two batch rows, a hop that does not divide WL: numpy's
    full FFT of the windowed frames within 1e-13 of max."""
    step = _hop(wl, "non-divisor")
    padded = _signal((2,), wl, step, T, wl, np.float64)
    win = hamming(wl)
    full = trfft.frames_rfft_full_fft(torch.from_numpy(padded),
                                      torch.from_numpy(win), wl, step, T)
    assert full.dtype == torch.complex128
    frames = np.lib.stride_tricks.sliding_window_view(
        padded, wl, axis=-1)[..., ::step, :][..., :T, :]
    oracle = np.fft.fft(frames * win, axis=-1)
    np.testing.assert_allclose(_np(full), oracle, rtol=0,
                               atol=1e-13 * np.abs(oracle).max())


@pytest.mark.parametrize("wl,step,t", [(256, 128, 9), (256, 64, 5),
                                       (400, 200, 7), (400, 100, 3)])
def test_full_store_matches_zaftpu(wl, step, t):
    """frames_rfft_full at a rule window (the FFT's full store, no
    operator) against zaftpu's B3 in interpret mode: float32, within 2e-6
    of max (the GEMM's rounding on zaftpu's side)."""
    padded = _signal((), wl, step, t, 31)
    win = hamming(wl).astype(np.float32)
    re, im = zfused.frames_rfft_full(jnp.asarray(padded), jnp.asarray(win),
                                     wl, step, t, interpret=True)
    calls = trfft.frames_rfft_full_fft_plain.calls
    mine = tfused.frames_rfft_full(torch.from_numpy(padded),
                                   torch.from_numpy(win), wl, step, t)
    assert trfft.frames_rfft_full_fft_plain.calls == calls + 1
    for got, ref in ((_np(mine).real, np.asarray(re)),
                     (_np(mine).imag, np.asarray(im))):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-6 * np.abs(ref).max())


# Counters of the analysis stores and the mirror: name -> plain version.
STORES = {"full_fft": trfft.frames_rfft_full_fft_plain,
          "full_gemm": tfused.frames_rfft_full_plain,
          "full_twin": tfused.frames_rfft_full_split4_plain,
          "half_fft": trfft.frames_rfft_fft_plain,
          "half_gemm": tfused.frames_rfft_plain,
          "half_twin": tfused.frames_rfft_split4_plain,
          "planes_fft": trfft.frames_matmul2_fft_plain,
          "planes_gemm": tfused.frames_matmul2_plain,
          "planes_twin": tfused.frames_matmul2_split4_plain,
          "mirror": tmirror.mirror_full_planes_plain,
          "framing": tframing.frame_window_plain}
LEVERS = {"none": {}, "ZAFTPU_MIRROR=pallas": {"ZAFTPU_MIRROR": "pallas"},
          "ZAFTPU_FUSED2=1": {"ZAFTPU_FUSED2": "1"},
          "ZAFTPU_FUSED=0": {"ZAFTPU_FUSED": "0"},
          "ZAFTPU_FFT=matmul": {"ZAFTPU_FFT": "matmul"}}
# A 7-smooth window, one through the odd-prime passes (1102 = 2 * 19 * 29)
# and one the static path refuses (262 = 2 * 131), where the full, half and
# planes stores run rfft_any's Bluestein.
RULE_WL, PRIME_WL, OFF_RULE_WL = 2048, 1102, 262


def _expected(fullspec, lever: str, dial: str, wl: int) -> set:
    """The counters stft moves: the lever's rule, stated once more. The
    full, half and planes stores take every window from 16 to 4,096
    unless ZAFTPU_FFT=matmul."""
    if lever == "ZAFTPU_FUSED=0":
        return {"framing"}
    matmul = lever == "ZAFTPU_FFT=matmul"
    gemm = "twin" if dial == "split4" else "gemm"
    full_fft = not matmul
    if fullspec is None:
        full = full_fft and lever not in ("ZAFTPU_MIRROR=pallas",
                                          "ZAFTPU_FUSED2=1")
    else:
        full = fullspec == "1"
    if full:
        return {f"full_{'fft' if full_fft else gemm}"}
    store = "planes" if lever == "ZAFTPU_FUSED2=1" else "half"
    mirror = {"mirror"} if lever == "ZAFTPU_MIRROR=pallas" else set()
    return {f"{store}_{gemm if matmul else 'fft'}"} | mirror


def _group(fullspec, lever: str, wl: int) -> str:
    """The analysis kernel whose sums the spectrum holds."""
    if lever == "ZAFTPU_FUSED=0":
        return "split"
    if lever == "ZAFTPU_FFT=matmul":
        return "gemm"
    return "fft"


def _agree(spec, ref, same_kernel: bool, dial: str) -> None:
    """Bit-equal where both ran the same analysis kernel, else within the
    dial's oracle gate (1e-5 of max exact, 1e-4 split4)."""
    if same_kernel:
        assert torch.equal(spec, ref)
        return
    ref = _np(ref)
    tol = 1e-4 if dial == "split4" else 1e-5
    np.testing.assert_allclose(_np(spec), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def _stft(x, wl, env: dict, monkeypatch):
    for name in ("ZAFTPU_FULLSPEC", *{k for v in LEVERS.values() for k in v}):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    return zaftpu_torch.stft(x, hamming(wl), wl // 2)


@pytest.mark.parametrize("wl", [RULE_WL, PRIME_WL, OFF_RULE_WL])
@pytest.mark.parametrize("dial", ["highest", "split4"])
@pytest.mark.parametrize("lever", list(LEVERS))
@pytest.mark.parametrize("fullspec", [None, "0", "1"])
def test_fullspec_lever_dispatch(fullspec, lever, dial, wl, monkeypatch):
    """Each combination moves exactly the counters the rule names, and its
    spectrum equals, bit for bit, that of ZAFTPU_FULLSPEC=0 under the same
    lever and of the lever-free default wherever both run the same
    analysis kernel on this dial (at WL 262 too: every store there runs
    Bluestein); across kernels within the dial's oracle gate (1e-5 of max
    exact, 1e-4 split4)."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    x = torch.from_numpy(np.random.default_rng(41).standard_normal(
        (2, 4 * wl)).astype(np.float32))
    env = dict(LEVERS[lever])
    if fullspec is not None:
        env["ZAFTPU_FULLSPEC"] = fullspec
    before = {k: c.calls for k, c in STORES.items()}
    spec = _stft(x, wl, env, monkeypatch)
    moved = {k for k, c in STORES.items() if c.calls != before[k]}
    assert moved == _expected(fullspec, lever, dial, wl)
    assert all(STORES[k].calls == before[k] + 1 for k in moved)
    assert spec.shape[:2] == (2, wl) and spec.dtype == torch.complex64
    group = _group(fullspec, lever, wl)
    same = _stft(x, wl, {**LEVERS[lever], "ZAFTPU_FULLSPEC": "0"},
                 monkeypatch)
    _agree(spec, same, group == _group("0", lever, wl), dial)
    default = _stft(x, wl, {}, monkeypatch)
    _agree(spec, default, group == _group(None, "none", wl), dial)


def test_unset_lever_takes_the_full_store_only_at_rule_windows(monkeypatch):
    """fullspec_enabled: ``1`` and ``0`` force, unset follows the rule
    (rfft.half_applies: every window from 16 to 4,096, not under
    ZAFTPU_FFT=matmul); any other value reads as unset."""
    for name in ("ZAFTPU_FULLSPEC", "ZAFTPU_MIRROR", "ZAFTPU_FUSED2",
                 "ZAFTPU_FFT"):
        monkeypatch.delenv(name, raising=False)
    assert tfused.fullspec_enabled(2048) and tfused.fullspec_enabled(400)
    assert tfused.fullspec_enabled(1102) and tfused.fullspec_enabled(2822)
    assert tfused.fullspec_enabled(262) and tfused.fullspec_enabled(441)
    assert not tfused.fullspec_enabled(8192)
    assert not tfused.fullspec_enabled(15)
    for value, rule, off_rule in (("1", True, True), ("0", False, False),
                                  ("auto", True, False)):
        monkeypatch.setenv("ZAFTPU_FULLSPEC", value)
        assert tfused.fullspec_enabled(2048) is rule
        assert tfused.fullspec_enabled(262) is rule
        assert tfused.fullspec_enabled(15) is off_rule
    monkeypatch.delenv("ZAFTPU_FULLSPEC")
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    assert not tfused.fullspec_enabled(2048)
    assert not tfused.fullspec_enabled(262)


def test_stft_matches_golden_under_the_unset_lever(golden, signal,
                                                   hamming_window,
                                                   monkeypatch):
    """The float64 stft through the full store's plain version against the
    reference goldens (1e-12, tests/test_torch_stft.py)."""
    monkeypatch.delenv("ZAFTPU_FULLSPEC", raising=False)
    calls = trfft.frames_rfft_full_fft_plain.calls
    mine = zaftpu_torch.stft(torch.from_numpy(signal), hamming_window, 1024)
    assert trfft.frames_rfft_full_fft_plain.calls == calls + 1
    ref = golden["stft"]
    assert tuple(mine.shape) == ref.shape and mine.dtype == torch.complex128
    np.testing.assert_allclose(_np(mine), ref, atol=1e-12)


def test_stft_matches_zaftpu_f32_under_the_unset_lever(signal,
                                                       hamming_window,
                                                       monkeypatch):
    """float32 stft through the full store against zaftpu's, within 1e-5
    of max (tests/test_torch_stft.py), and its round trip against
    zaftpu's istft of zaftpu's spectrum."""
    monkeypatch.delenv("ZAFTPU_FULLSPEC", raising=False)
    x32 = signal.astype(np.float32)
    w32 = hamming_window.astype(np.float32)
    ref = np.asarray(zaftpu.stft(x32, w32, 1024))
    mine = zaftpu_torch.stft(torch.from_numpy(x32), w32, 1024)
    assert mine.dtype == torch.complex64 and tuple(mine.shape) == ref.shape
    for got, want in ((_np(mine).real, ref.real), (_np(mine).imag, ref.imag)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    rec = zaftpu_torch.istft(mine, w32, 1024)
    ref_rec = np.asarray(zaftpu.istft(ref, w32, 1024))
    np.testing.assert_allclose(_np(rec), ref_rec, rtol=0,
                               atol=1e-5 * np.abs(ref_rec).max())
