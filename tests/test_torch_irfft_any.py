"""The inverse real-FFT + overlap-add kernel and the real-FFT kernel's full
store at every window from 16 to 4,096 (zaftpu_torch/kernels/irfft.py:
istft_ola_fft; zaftpu_torch/kernels/rfft.py: frames_rfft_full_fft): B4's
and B3's function, which synth.istft_ola and fused.frames_rfft_full hand
them on every dial wherever no operator is given and ZAFTPU_FFT is not
matmul. At a window rfft.fits refuses the inverse runs irfft_any: an odd
window takes each frame's conjugated Hermitian extension as one complex
N-point FFT, an FFT length with a prime factor above 127 (131 at WL 262,
1,031 at WL 2,062, 2,039 at WL 4,078) runs by Bluestein's chirp
z-transform on the same passes; the full store writes rfft_any's bins and
their conjugate mirror.

The inverse's plain version against a float64 numpy irfft and overlap-add
and zaftpu's synthesis (its Pallas istft_ola in interpret mode where that
kernel takes the hop, else its folded inverse DFT and overlap-add), silent
frames, istft and stft through the entry points on every dial against
zaftpu in float32 and, on the golden signal, in float64 and a numpy DFT
(the goldens hold no window off the FFT rule), the full store's plain
version against the half store's and the conjugate mirror, the route on
every dial and lever, and the sharded round trip at an odd window on a
one-rank gloo world. The kernels themselves run on the card
(tests/test_torch_cuda.py and chip_smoke.py hold them against these plain
versions there).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import zaftpu
import zaftpu_torch
from test_torch_irfft import SCALE, _oracle, _zaftpu_ola
from test_torch_mel_fft_any import ORACLE_WINDOWS, ZAFTPU_CASES
from test_torch_rfft_any import STFT_CASES
from zaftpu.core.windows import hamming
from zaftpu_torch.core import fft as tfft
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import irfft as tirfft
from zaftpu_torch.kernels import rfft as trfft
from zaftpu_torch.kernels import synth as tsynth
from zaftpu_torch.sharding import (gather, initialize_distributed,
                                   istft_sharded, make_mesh, stft_sharded)
from zaftpu_torch.transforms.stft import centre_padded

# An odd frame count, two rows.
FRAMES, ROWS = 7, 2
HOPS = ["1", "non-divisor", "whole"]
# The pass counts of the lowered dials, as policy.gemm_passes gives them on
# CUDA (on the CPU high and default run exact, so the tests patch it in).
PASSES = {"split4": 4, "high": 3, "default": 1}
SYNTH_PLAINS = (tirfft.istft_ola_fft_plain, tsynth.istft_ola_plain,
                tsynth.istft_ola_split4_plain)
# istft's synthesis: the fused fold (the Hermitian fold in the inverse's
# load) at every window from 16 to 4,096, or the fold and then one of
# SYNTH_PLAINS.
ISTFT_PLAINS = (tirfft.istft_ola_fft_full_plain,) + SYNTH_PLAINS
ANALYSIS_PLAINS = (trfft.frames_rfft_full_fft_plain,
                   trfft.frames_rfft_fft_plain,
                   trfft.frames_matmul2_fft_plain,
                   tfused.frames_rfft_full_plain,
                   tfused.frames_rfft_full_split4_plain,
                   tfused.frames_rfft_plain, tfused.frames_rfft_split4_plain)


@pytest.fixture(autouse=True)
def levers(monkeypatch):
    """The analysis and synthesis levers and the dial start unset."""
    for name in ("ZAFTPU_FFT", "ZAFTPU_PRECISION", "ZAFTPU_FUSED2",
                 "ZAFTPU_FULLSPEC", "ZAFTPU_MIRROR", "ZAFTPU_FUSED",
                 "ZAFTPU_SYNTH"):
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
    """Set ZAFTPU_PRECISION and give the analysis's and the synthesis's
    dispatch the dial's pass count on the CPU too, so that a route that
    reached the twins would show."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    if dial in PASSES:
        def passes(dtype, device):
            return PASSES[dial] if dtype == torch.float32 else None
        monkeypatch.setattr(tfused, "gemm_passes", passes)
        monkeypatch.setattr(tsynth, "gemm_passes", passes)


def _hop(wl, kind):
    return {"1": 1, "non-divisor": wl // 3 + 1, "whole": wl}[kind]


def _planes(lead, wl, t, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, *lead, t, wl // 2 + 1)).astype(dtype)


def _calls(fns):
    return [f.calls for f in fns]


@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("wl", ORACLE_WINDOWS)
def test_inverse_plain_against_float64_irfft(wl, hop):
    """The inverse's plain version at every layout (the static path, odd
    windows in each block, Bluestein with an even and an odd N) and a hop
    of 1, one that does not divide the window and N, two rows and an odd
    frame count: float32 within 1e-6 of max of numpy's float64 irfft and
    overlap-add (the float32 FFT rounds to 2e-7-9e-7 of max here), float64
    within 1e-12 of max."""
    step = _hop(wl, hop)
    h = _planes((ROWS,), wl, FRAMES, wl + step, np.float64)
    ref = _oracle(h, wl, step)
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        hr, hi = (torch.from_numpy(a).to(dtype) for a in h)
        mine = tirfft.istft_ola_fft(hr, hi, wl, step, SCALE)
        assert mine.dtype == dtype and mine.shape == ref.shape
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("wl,step,sr", ZAFTPU_CASES)
def test_synthesis_matches_zaftpu(wl, step, sr):
    """synth.istft_ola on float32 planes (the inverse's plain version from
    16 up, B4's below) within 2e-6 of max of zaftpu's synthesis (its float32
    GEMM rounds to about 1e-6 of max at these shapes)."""
    h = _planes((), wl, 5, wl + sr)
    ref = _zaftpu_ola(h[0], h[1], wl, step)
    calls = _calls(SYNTH_PLAINS)
    mine = tsynth.istft_ola(torch.from_numpy(h[0]), torch.from_numpy(h[1]),
                            wl, step, SCALE)
    want = [1, 0, 0] if wl >= trfft.MIN_WINDOW else [0, 1, 0]
    assert [b - a for a, b in zip(calls, _calls(SYNTH_PLAINS))] == want
    assert mine.dtype == torch.float32 and mine.shape == ref.shape
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("dial", ["highest", "split4"])
@pytest.mark.parametrize("wl,step", STFT_CASES)
def test_round_trip_matches_zaftpu_f32(golden, wl, step, dial, monkeypatch):
    """stft -> istft of the golden signal in float32 at the odd and
    Bluestein windows, on both dials: stft calls the full store's plain
    version once and istft the fused fold's once, no GEMM or twin; the
    spectrum within 2e-6 of max of zaftpu.stft and the synthesis within
    2e-6 of max of zaftpu.istft of the same spectrum."""
    x32 = golden["signal"].astype(np.float32)
    w32 = hamming(wl).astype(np.float32)
    _dial(dial, monkeypatch)
    calls = _calls(ANALYSIS_PLAINS + ISTFT_PLAINS)
    spec = zaftpu_torch.stft(torch.from_numpy(x32), w32, step)
    rec = zaftpu_torch.istft(spec, w32, step)
    moved = [b - a for a, b in zip(calls, _calls(ANALYSIS_PLAINS
                                                 + ISTFT_PLAINS))]
    assert moved == [1] + [0] * (len(ANALYSIS_PLAINS) - 1) + [1, 0, 0, 0]
    ref = np.asarray(zaftpu.stft(x32, w32, step))
    assert spec.shape == ref.shape and spec.dtype == torch.complex64
    assert np.abs(spec.numpy() - ref).max() <= 2e-6 * np.abs(ref).max()
    ref = np.asarray(zaftpu.istft(spec.numpy(), w32, step))
    assert rec.shape == ref.shape and rec.dtype == torch.float32
    assert np.abs(rec.numpy() - ref).max() <= 2e-6 * np.abs(ref).max()


def _numpy_istft(spec, win, step):
    """The reference's istft (zaf.py:223-243) in float64 numpy: real(ifft)
    of each frame, overlap-added, divided by the COLA gain, trimmed."""
    wl, t = spec.shape
    frames = np.fft.ifft(spec.T, axis=-1).real
    out = np.zeros((t - 1) * step + wl)
    for i in range(t):
        out[i * step:i * step + wl] += frames[i]
    edge = wl - step
    return out[edge:out.shape[0] - edge] / win[::step].sum()


@pytest.mark.parametrize("wl,step", STFT_CASES)
def test_round_trip_float64_matches_zaftpu_and_numpy(golden, wl, step):
    """float64 (the oracle mode): stft -> istft of the golden signal
    through the full store's and the fused fold's plain versions, the
    spectrum within 1e-12 of max of zaftpu.stft and of a numpy DFT, the
    synthesis within 1e-12 of max of zaftpu.istft and of numpy's istft of
    the same spectrum."""
    x = golden["signal"].astype(np.float64)
    win = hamming(wl)
    calls = _calls((trfft.frames_rfft_full_fft_plain,
                    tirfft.istft_ola_fft_full_plain))
    spec = zaftpu_torch.stft(torch.from_numpy(x), win, step).numpy()
    rec = zaftpu_torch.istft(torch.from_numpy(spec), win, step).numpy()
    assert _calls((trfft.frames_rfft_full_fft_plain,
                   tirfft.istft_ola_fft_full_plain)) == [c + 1 for c in calls]
    ref = np.asarray(zaftpu.stft(x, win, step))
    scale = np.abs(ref).max()
    assert spec.dtype == np.complex128
    assert np.abs(spec - ref).max() <= 1e-12 * scale
    padded, t = centre_padded(torch.from_numpy(x), wl, step)
    frames = np.lib.stride_tricks.sliding_window_view(padded.numpy(),
                                                      wl)[::step][:t]
    oracle = np.fft.fft(frames * win, axis=-1).T
    assert np.abs(spec - oracle).max() <= 1e-12 * scale
    for ref in (np.asarray(zaftpu.istft(spec, win, step)),
                _numpy_istft(spec, win, step)):
        assert rec.shape == ref.shape and rec.dtype == np.float64
        assert np.abs(rec - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("wl", ORACLE_WINDOWS)
def test_full_store_plain_is_the_half_store_mirrored(wl):
    """The full store's plain version equals, bit for bit, the conjugate
    mirror of the half store's (bin WL - k the conjugate of bin k, k = 1 ..
    (WL-1)/2: the mirror, not an odd FFT's own upper bins), and a float64
    numpy FFT within 1e-6 of max."""
    step = wl // 3 + 1
    rng = np.random.default_rng(wl)
    x = torch.from_numpy(rng.standard_normal(
        (ROWS, (FRAMES - 1) * step + wl)).astype(np.float32))
    w = torch.from_numpy(hamming(wl).astype(np.float32))
    full = trfft.frames_rfft_full_fft(x, w, wl, step, FRAMES)
    half = trfft.frames_rfft_fft(x, w, wl, step, FRAMES)
    assert full.shape == (ROWS, FRAMES, wl)
    assert torch.equal(full, tfft.conjugate_mirror(half, wl))
    frames = x.double().unfold(-1, wl, step)[..., :FRAMES, :] * w.double()
    oracle = torch.fft.fft(frames, dim=-1)
    assert float((full.to(torch.complex128) - oracle).abs().max()) <= (
        1e-6 * float(oracle.abs().max()))


@pytest.mark.parametrize("dial", ["highest", "split4", "high", "default"])
@pytest.mark.parametrize("wl,step", STFT_CASES)
def test_stft_takes_the_full_store_on_every_dial(golden, wl, step, dial,
                                                 monkeypatch):
    """stft at the odd and Bluestein windows runs the full store's plain
    version once and nothing else on every dial (the lowered dials with
    their pass count patched in), bit-equal to ZAFTPU_FULLSPEC=0's half
    store and index mirror."""
    x = torch.from_numpy(golden["signal"].astype(np.float32))
    w32 = hamming(wl).astype(np.float32)
    _dial(dial, monkeypatch)
    calls = _calls(ANALYSIS_PLAINS)
    spec = zaftpu_torch.stft(x, w32, step)
    assert [b - a for a, b in zip(calls, _calls(ANALYSIS_PLAINS))] == [
        1] + [0] * (len(ANALYSIS_PLAINS) - 1)
    monkeypatch.setenv("ZAFTPU_FULLSPEC", "0")
    assert torch.equal(spec, zaftpu_torch.stft(x, w32, step))


@pytest.mark.parametrize("wl", [441, 262, 1031, 2205, 3093])
@pytest.mark.parametrize("hop", ["whole", "third"])
def test_silent_frames_give_exact_zeros(wl, hop):
    """Frames whose planes are all zero give exactly 0 in the samples that
    no other frame reaches (each frame is its own FFT: nothing of a loud
    neighbour rounds into them), at the hop N (disjoint frames) and N/3
    (three silent frames in a row cover samples alone); every other
    sample within 1e-6 of max of numpy's float64 irfft."""
    step = wl if hop == "whole" else wl // 3
    silent = np.array([False, True, True, True, False, False, True])
    h = _planes((), wl, len(silent), wl)
    h[:, silent] = 0.0
    out = tirfft.istft_ola_fft(*torch.from_numpy(h), wl, step, 1.0).numpy()
    reach = np.zeros(out.shape[0], bool)
    for i in np.flatnonzero(~silent):
        reach[i * step:i * step + wl] = True
    assert (~reach).any()
    assert not out[~reach].any()
    ref = _oracle(h, wl, step, 1.0)
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("dial", ["highest", "split4", "high", "default"])
@pytest.mark.parametrize("lever", [None, "matmul", "operator", "below 16"])
def test_synthesis_route_on_every_dial_and_lever(dial, lever, monkeypatch):
    """synth.istft_ola on float32 CPU planes at the odd and Bluestein
    windows: the inverse's plain version with no lever on every dial; B4's
    GEMM plain version, or on a lowered dial its twin's, under
    ZAFTPU_FFT=matmul, with an explicit operator and at WL 15; nothing else
    runs."""
    _dial(dial, monkeypatch)
    if lever == "matmul":
        monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    for wl in ((15,) if lever == "below 16" else (441, 262, 2062, 3093)):
        step = wl // 2
        h = torch.from_numpy(_planes((), wl, 3, wl))
        ops = (tsynth.istft_ops(wl, SCALE, torch.float32, "cpu")
               if lever == "operator" else None)
        calls = _calls(SYNTH_PLAINS)
        tsynth.istft_ola(h[0], h[1], wl, step, SCALE, ops)
        want = (tirfft.istft_ola_fft_plain if lever is None
                else tsynth.istft_ola_split4_plain if dial in PASSES
                else tsynth.istft_ola_plain)
        assert [b - a for a, b in zip(calls, _calls(SYNTH_PLAINS))] == [
            int(f is want) for f in SYNTH_PLAINS], (wl, lever)
        assert tirfft.applies(wl, ops) is (lever is None)


def test_sharded_round_trip_one_rank_at_an_odd_window(golden, tmp_path):
    """stft_sharded -> istft_sharded (the block passed on) at WL 441 / hop
    147 on a one-rank gloo world (this process) equals istft of stft of the
    same tensor bit for bit, through the fused fold's plain version, and
    zaftpu.istft of zaftpu.stft within 2e-6 of max."""
    wl, step = 441, 147
    x32 = golden["signal"].astype(np.float32)
    win = hamming(wl).astype(np.float32)
    x = torch.from_numpy(x32)
    whole = zaftpu_torch.istft(zaftpu_torch.stft(x, win, step), win, step)
    assert not dist.is_initialized()
    initialize_distributed(device="cpu",
                           init_method=f"file://{tmp_path}/store", rank=0,
                           world_size=1)
    try:
        mesh = make_mesh(1)
        calls = tirfft.istft_ola_fft_full_plain.calls
        block = stft_sharded(x, win, step, mesh)
        got = gather(istft_sharded(block, win, step, mesh, block=True), mesh)
        assert tirfft.istft_ola_fft_full_plain.calls == calls + 1
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, whole)
    ref = np.asarray(zaftpu.istft(zaftpu.stft(x32, win, step), win, step))
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 2e-6 * np.abs(ref).max()
