"""The real-FFT kernel's half and planes stores at every window from 16 to
4,096 (zaftpu_torch/kernels/rfft.py: frames_rfft_fft, frames_matmul2_fft):
B1's and B12's function, which fused.frames_rfft and fused.frames_matmul2
hand them on every dial wherever no operator is given and ZAFTPU_FFT is
not matmul. At a window rfft.fits refuses they run rfft_any: an odd window
takes each frame as the real parts of one complex N-point FFT, an FFT
length with a prime factor above 127 (131 at WL 262, 1,031 at WL 2,062,
2,039 at WL 4,078) runs by Bluestein's chirp z-transform on the same
passes.

Their plain versions against a float64 numpy DFT and zaftpu's fused
analysis (Pallas, interpret mode; one row a call at a hop that divides the
window), the magnitude store's plain version against the half store's
bins, a quiet frame beside loud ones, stft through the stores on every dial
and under ZAFTPU_FUSED2=1 against zaftpu and a float64 DFT, the dispatch
on every dial and lever, and the sharded stft and griffin_lim at an odd
window against zaftpu. The goldens hold no window off the FFT rule
(their stft is WL 2,048), so the float64 cases run on the golden signal
against zaftpu in float64 and a numpy DFT. The kernel itself runs on the
card (tests/test_torch_cuda.py and chip_smoke.py hold it bit-equal to
these plain versions there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import zaftpu
import zaftpu_torch
from test_torch_kernels import _gemm_close
from test_torch_mel_fft_any import ORACLE_WINDOWS, ZAFTPU_CASES
from zaftpu.core.windows import hamming
from zaftpu.pallas import fused as zfused
from zaftpu.transforms.griffinlim import griffin_lim as zgriffin_lim
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import irfft as tirfft
from zaftpu_torch.kernels import melfft as tmelfft
from zaftpu_torch.kernels import rfft as trfft
from zaftpu_torch.sharding import (initialize_distributed, make_mesh,
                                   stft_sharded)
from zaftpu_torch.transforms.stft import centre_padded

# An odd frame count, two rows.
FRAMES, ROWS = 7, 2
# stft through the half store: 10 ms (441: a complex FFT a frame), 30 ms
# (1,323), 2,062 (Bluestein at P 2,304) and 4,078 (P 4,096), at the hops
# chip_smoke.ANY_WINDOWS gives them.
STFT_CASES = [(441, 147), (1323, 441), (2062, 512), (4078, 1024)]
# The pass counts of the lowered dials, as policy.gemm_passes gives them on
# CUDA (on the CPU high and default run exact, so the tests patch it in).
PASSES = {"split4": 4, "high": 3, "default": 1}
GEMM_PLAINS = (tfused.frames_rfft_plain, tfused.frames_rfft_split4_plain,
               tfused.frames_matmul2_plain, tfused.frames_matmul2_split4_plain)


@pytest.fixture(autouse=True)
def levers(monkeypatch):
    """The analysis levers and the dial start unset."""
    for name in ("ZAFTPU_FFT", "ZAFTPU_PRECISION", "ZAFTPU_FUSED2",
                 "ZAFTPU_FULLSPEC", "ZAFTPU_MIRROR", "ZAFTPU_FUSED"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain versions' many small operations
    (Bluestein's passes above all) ran about 100 times slower when the test
    workers' OpenMP threads oversubscribed the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dial(dial, monkeypatch):
    """Set ZAFTPU_PRECISION and give fused's dispatch the dial's pass count
    on the CPU too, so that a route that reached the twins would show."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    if dial in PASSES:
        monkeypatch.setattr(
            tfused, "gemm_passes",
            lambda dtype, device: PASSES[dial]
            if dtype == torch.float32 else None)


def _signal(wl, step, t, seed, rows=ROWS, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, (t - 1) * step + wl)).astype(dtype)


def _oracle_half(padded, win, wl, step, t):
    """Float64 numpy rfft of the windowed frames, bins 0..WL//2."""
    frames = np.lib.stride_tricks.sliding_window_view(
        padded.astype(np.float64), wl, axis=-1)[..., ::step, :][..., :t, :]
    return np.fft.rfft(frames * win.astype(np.float64), axis=-1)


def _calls():
    return [f.calls for f in (trfft.frames_rfft_fft_plain,
                              trfft.frames_matmul2_fft_plain, *GEMM_PLAINS)]


@pytest.mark.parametrize("wl", ORACLE_WINDOWS)
def test_half_and_planes_against_float64_dft(wl):
    """Both stores' float32 plain versions within 1e-6 of max of a float64
    numpy DFT at a hop that does not divide the window, two rows and an odd
    frame count, the planes bit-equal to the half spectrum; in float64 they
    compute in float64, within 1e-12 of max."""
    step, t = wl // 3 + 1, FRAMES
    padded = _signal(wl, step, t, wl + 2)
    win = hamming(wl).astype(np.float32)
    x, w = torch.from_numpy(padded), torch.from_numpy(win)
    oracle = _oracle_half(padded, win, wl, step, t)
    half = trfft.frames_rfft_fft(x, w, wl, step, t)
    assert half.shape == oracle.shape == (ROWS, t, wl // 2 + 1)
    assert half.dtype == torch.complex64
    scale = np.abs(oracle).max()
    assert np.abs(half.numpy() - oracle).max() <= 1e-6 * scale
    re, im = trfft.frames_matmul2_fft(x, w, wl, step, t)
    assert re.dtype == torch.float32
    assert torch.equal(torch.complex(re, im), half)
    half64 = trfft.frames_rfft_fft(x.double(), w.double(), wl, step, t)
    assert half64.dtype == torch.complex128
    assert np.abs(half64.numpy() - oracle).max() <= 1e-12 * scale


@pytest.mark.parametrize("fused2", [False, True])
@pytest.mark.parametrize("wl,step,sr", ZAFTPU_CASES)
def test_half_and_planes_match_zaftpu(wl, step, sr, fused2, monkeypatch):
    """frames_rfft (frames_matmul2 under ZAFTPU_FUSED2=1) on a batch of two
    rows in one call through the stores' plain versions (below 16, B1's
    GEMM plain version, which the route takes there): the first row
    against zaftpu's fused analysis (its frames_matmul2 under the lever,
    one row a call) at tests/test_torch_mel_fft_any.py's tolerance, with
    the float64 DFT beside it, the second bit-equal to a call on that row
    alone."""
    if fused2:
        monkeypatch.setenv("ZAFTPU_FUSED2", "1")
    padded = _signal(wl, step, FRAMES, wl)
    win = hamming(wl).astype(np.float32)
    x, w = torch.from_numpy(padded), torch.from_numpy(win)
    ref = np.asarray(zfused.frames_rfft(jnp.asarray(padded[0]),
                                        jnp.asarray(win), wl, step, FRAMES,
                                        interpret=True))
    calls = _calls()
    mine = tfused.frames_rfft(x, w, wl, step, FRAMES)
    store = trfft.frames_matmul2_fft_plain if fused2 else \
        trfft.frames_rfft_fft_plain
    gemm = tfused.frames_matmul2_plain if fused2 else \
        tfused.frames_rfft_plain
    want = store if trfft.half_applies(wl) else gemm
    assert [b - a for a, b in zip(calls, _calls())] == [
        int(f is want) for f in (trfft.frames_rfft_fft_plain,
                                 trfft.frames_matmul2_fft_plain,
                                 *GEMM_PLAINS)]
    assert mine.shape == (ROWS, *ref.shape) and mine.dtype == torch.complex64
    oracle = _oracle_half(padded[0], win, wl, step, FRAMES)
    for part in (np.real, np.imag):
        _gemm_close(part(mine[0].numpy()), part(ref), part(oracle))
    assert torch.equal(mine[1], tfused.frames_rfft(x[1], w, wl, step,
                                                   FRAMES))


@pytest.mark.parametrize("wl", ORACLE_WINDOWS)
def test_magnitude_store_is_the_half_stores_bins(wl):
    """The magnitude store's plain version equals the correctly rounded
    root of re*re + im*im of the half store's bins 1..WL//2, bit for bit,
    on every path."""
    step, t = wl // 2 + 1, 5
    x = torch.from_numpy(_signal(wl, step, t, wl + 3))
    w = torch.from_numpy(hamming(wl).astype(np.float32))
    half = trfft.frames_rfft_fft(x, w, wl, step, t)[..., 1:]
    re, im = half.real, half.imag
    want = torch.sqrt((re * re + im * im).double()).float()
    assert torch.equal(tmelfft.spec_rows_fft(x, w, wl, step, t), want)


# Five disjoint frames (the hop is the window): loud, silent, -80 dB, loud,
# loud.
QUIET_GAINS = (1.0, 0.0, 1e-4, 1.0, 1.0)


@pytest.mark.parametrize("wl", [441, 1031, 2062, 2205])
def test_quiet_frame_beside_loud_ones(wl, capsys):
    """QUIET_GAINS' frames through the half and planes stores: each frame's
    error against a float64 DFT within 1e-6 of that frame's own max, a
    silent frame's bins exactly zero (DC included), as B1's plain version
    (the ZAFTPU_FFT=matmul route, printed beside): no frame's bins carry
    another frame's rounding."""
    rng = np.random.default_rng(wl)
    gains = np.array(QUIET_GAINS)
    padded = (rng.standard_normal((len(gains), wl))
              * gains[:, None]).reshape(-1).astype(np.float32)
    win = hamming(wl).astype(np.float32)
    t = len(gains)
    oracle = _oracle_half(padded, win, wl, wl, t)
    x, w = torch.from_numpy(padded), torch.from_numpy(win)
    half = trfft.frames_rfft_fft(x, w, wl, wl, t).numpy()
    re, im = trfft.frames_matmul2_fft(x, w, wl, wl, t)
    gemm = tfused.frames_rfft_plain(x, w, wl, wl, t).numpy()
    own = np.abs(oracle).max(axis=-1)
    errs = [np.abs(a - oracle).max(axis=-1) for a in (half, gemm)]
    with capsys.disabled():
        for f in range(t):
            print(f"\nWL {wl} frame {f} (gain {QUIET_GAINS[f]}): half store "
                  f"{errs[0][f]:.3g}, B1 {errs[1][f]:.3g} (frame max "
                  f"{own[f]:.3g})", end="")
    assert (errs[0] <= 1e-6 * own).all()
    assert not half[1].any() and not gemm[1].any()
    assert not re[1].any() and not im[1].any()


def _zaftpu_stft(x, win, step):
    """zaftpu.stft in the input's dtype, with every lever unset."""
    return np.asarray(zaftpu.stft(x, win, step))


@pytest.mark.parametrize("fused2", [False, True])
@pytest.mark.parametrize("dial", ["highest", "split4", "high", "default"])
@pytest.mark.parametrize("wl,step", STFT_CASES)
def test_stft_takes_the_half_store_on_every_dial(golden, wl, step, dial,
                                                 fused2, monkeypatch):
    """stft of the golden signal in float32 at the odd and Bluestein
    windows under ZAFTPU_FULLSPEC=0 calls the half store's plain version
    once (the planes store's under ZAFTPU_FUSED2=1) and no GEMM or twin
    plain version, on every dial (the lowered dials with their pass count
    patched in); within 2e-6 of max of zaftpu.stft in float32 and 1e-6 of
    max of a float64 DFT. (Unset, ZAFTPU_FULLSPEC gives the full store:
    tests/test_torch_irfft_any.py.)"""
    x32 = golden["signal"].astype(np.float32)
    w32 = hamming(wl).astype(np.float32)
    ref = _zaftpu_stft(x32, w32, step)
    _dial(dial, monkeypatch)
    monkeypatch.setenv("ZAFTPU_FULLSPEC", "0")
    if fused2:
        monkeypatch.setenv("ZAFTPU_FUSED2", "1")
    calls = _calls()
    mine = zaftpu_torch.stft(torch.from_numpy(x32), w32, step).numpy()
    want = [0, 1] if fused2 else [1, 0]
    assert [b - a for a, b in zip(calls, _calls())] == want + [0] * 4
    assert mine.shape == ref.shape and mine.dtype == np.complex64
    scale = np.abs(ref).max()
    assert np.abs(mine - ref).max() <= 2e-6 * scale
    padded, _ = centre_padded(torch.from_numpy(x32.astype(np.float64)), wl,
                              step)
    oracle = _oracle_half(padded.numpy(), w32, wl, step, mine.shape[-1])
    assert np.abs(mine[:wl // 2 + 1].T - oracle).max() <= 1e-6 * scale


@pytest.mark.parametrize("wl,step", STFT_CASES)
def test_stft_float64_matches_zaftpu(golden, wl, step, monkeypatch):
    """float64 (the oracle mode): stft of the golden signal through the
    half store's plain version (ZAFTPU_FULLSPEC=0) within 1e-12 of max of
    zaftpu.stft in float64 and of a numpy DFT, the mirrored bins the
    conjugates."""
    monkeypatch.setenv("ZAFTPU_FULLSPEC", "0")
    x = golden["signal"].astype(np.float64)
    win = hamming(wl)
    calls = trfft.frames_rfft_fft_plain.calls
    mine = zaftpu_torch.stft(torch.from_numpy(x), win, step).numpy()
    assert trfft.frames_rfft_fft_plain.calls == calls + 1
    ref = _zaftpu_stft(x, win, step)
    assert mine.shape == ref.shape and mine.dtype == np.complex128
    scale = np.abs(ref).max()
    assert np.abs(mine - ref).max() <= 1e-12 * scale
    padded, t = centre_padded(torch.from_numpy(x), wl, step)
    oracle = _oracle_half(padded.numpy(), win, wl, step, t)
    assert np.abs(mine[:wl // 2 + 1].T - oracle).max() <= 1e-12 * scale
    assert np.array_equal(mine[wl // 2 + 1:][::-1],
                          np.conj(mine[1:(wl + 1) // 2]))


@pytest.mark.parametrize("dial", ["highest", "split4", "high", "default"])
def test_half_rule_at_every_window(dial, monkeypatch):
    """rfft.half_applies holds at every window from 16 to 4,096 on every
    dial, and not below 16, above 4,096, with an explicit operator or under
    ZAFTPU_FFT=matmul (native follows it); fused.fullspec_enabled and the
    inverse's rule (irfft.applies) follow it, rfft.applies keeps the
    static path's rule (rfft.fits), so the MDCT and Griffin-Lim's pairing
    keep their windows."""
    _dial(dial, monkeypatch)
    every = range(16, 4097)
    assert all(trfft.half_applies(wl) for wl in every)
    assert not any(trfft.half_applies(wl) for wl in (*range(2, 16), 4097))
    assert not trfft.half_applies(2062, ops=torch.zeros(1))
    assert [wl for wl in every if trfft.applies(wl)] == [
        wl for wl in every if trfft.fits(wl)]
    assert all(tfused.fullspec_enabled(wl) and tirfft.applies(wl)
               for wl in every)
    assert not any(tfused.fullspec_enabled(wl) or tirfft.applies(wl)
                   for wl in (15, 4097))
    monkeypatch.setenv("ZAFTPU_FFT", "native")
    assert all(trfft.half_applies(wl) for wl in every)
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    assert not any(trfft.half_applies(wl) for wl in every)


@pytest.mark.parametrize("dial", ["highest", "split4", "high", "default"])
@pytest.mark.parametrize("lever", [None, "matmul", "operator", "below 16"])
@pytest.mark.parametrize("fused2", [False, True])
def test_dispatch_on_every_dial_and_lever(dial, lever, fused2, monkeypatch):
    """fused.frames_rfft and fused.frames_matmul2 on a float32 CPU signal
    at the odd and Bluestein windows: the half (planes) store's plain
    version with no lever; B1's (B12's) GEMM plain version, or on a
    lowered dial its twin's, under ZAFTPU_FFT=matmul, with an explicit
    operator and at WL 15; nothing else runs."""
    _dial(dial, monkeypatch)
    if lever == "matmul":
        monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    for wl in ((15,) if lever == "below 16" else (441, 262, 2062, 3093)):
        step, t = wl // 2, 3
        x = torch.from_numpy(_signal(wl, step, t, wl, rows=1)[0])
        w = torch.from_numpy(hamming(wl).astype(np.float32))
        ops = (tfused.rdft_ops(wl, torch.float32, "cpu")
               if lever == "operator" else None)
        fn = tfused.frames_matmul2 if fused2 else tfused.frames_rfft
        calls = _calls()
        fn(x, w, wl, step, t, ops)
        if lever is None:
            want = (trfft.frames_matmul2_fft_plain if fused2
                    else trfft.frames_rfft_fft_plain)
        elif dial in PASSES:
            want = (tfused.frames_matmul2_split4_plain if fused2
                    else tfused.frames_rfft_split4_plain)
        else:
            want = (tfused.frames_matmul2_plain if fused2
                    else tfused.frames_rfft_plain)
        assert [b - a for a, b in zip(calls, _calls())] == [
            int(f is want) for f in (trfft.frames_rfft_fft_plain,
                                     trfft.frames_matmul2_fft_plain,
                                     *GEMM_PLAINS)], (wl, lever)


def test_sharded_stft_one_rank_at_an_odd_window(golden, tmp_path):
    """stft_sharded at WL 441 / hop 147 on a one-rank gloo world (this
    process) equals stft of the same tensor bit for bit, through the full
    store's plain version, and zaftpu.stft within 2e-6 of max."""
    wl, step = 441, 147
    x32 = golden["signal"].astype(np.float32)
    win = hamming(wl).astype(np.float32)
    x = torch.from_numpy(x32)
    whole = zaftpu_torch.stft(x, win, step)
    assert not dist.is_initialized()
    initialize_distributed(device="cpu",
                           init_method=f"file://{tmp_path}/store", rank=0,
                           world_size=1)
    try:
        calls = trfft.frames_rfft_full_fft_plain.calls
        got = stft_sharded(x, win, step, make_mesh(1))
        assert trfft.frames_rfft_full_fft_plain.calls > calls
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, whole)
    ref = _zaftpu_stft(x32, win, step)
    assert np.abs(got.numpy() - ref).max() <= 2e-6 * np.abs(ref).max()


@pytest.mark.parametrize("wl,step", [(441, 147), (262, 131)])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-4)])
def test_griffin_lim_off_the_rule_matches_zaftpu(wl, step, dtype, tol):
    """griffin_lim at an odd window (441) and a Bluestein one (262), whose
    analysis is the half store's plain version, against zaftpu's after 5
    iterations on the same magnitudes (tests/test_torch_griffinlim.py's
    tolerances)."""
    x = np.random.default_rng(wl + step).standard_normal(8820)
    mag = np.abs(np.asarray(zaftpu.stft(x, hamming(wl), step)))
    mag = mag[:wl // 2 + 1].astype(dtype)
    win = hamming(wl).astype(dtype)
    calls = trfft.frames_rfft_fft_plain.calls
    mine = zaftpu_torch.griffin_lim(torch.from_numpy(mag), win, step,
                                    iterations=5).numpy()
    assert trfft.frames_rfft_fft_plain.calls == calls + 5
    ref = np.asarray(zgriffin_lim(mag, win, step, iterations=5))
    assert mine.shape == ref.shape and mine.dtype == ref.dtype
    assert np.abs(mine - ref).max() <= tol * np.abs(ref).max()
