"""The real-FFT kernel's magnitude and mel stores at every window from 16 to
4,096 (zaftpu_torch/kernels/melfft.py): an odd window takes each frame as
the real parts of one complex N-point FFT, and an FFT length with a prime
factor above 127 (131 at WL 262, 1,031 at WL 2,062 and 1,031, 2,039 at WL
4,078) runs by Bluestein's chirp z-transform on the same passes. Their
plain versions against zaftpu's spec_rows and mel_rows (Pallas, interpret
mode) and a float64 numpy DFT, frame by frame where a quiet frame lies
beside a loud one, the public front ends against zaftpu, the front ends'
route at every window on every dial, and the streaming and sharded row
functions against the whole transform.

zaftpu's one-pass kernels take one row and a hop that divides the window,
so they are called row by row at such hops; a hop that does not divide the
window meets zaftpu through its public functions (WL 2,062, hop 512) and
the float64 DFT. The kernel itself runs on the card (tests/test_torch_cuda.py
and chip_smoke.py hold it bit-equal to these plain versions there).
"""

import numpy as np
import pytest
import scipy.io.wavfile
import torch
import torch.distributed as dist

import jax.numpy as jnp
import zaftpu
import zaftpu_torch
from test_torch_kernels import _gemm_close
from zaftpu.core.windows import hamming
from zaftpu.features import mel as zmel
from zaftpu.pallas import melfused as zmelfused
from zaftpu.transforms.stft import spectrogram as zspectrogram
from zaftpu_torch.io import pipeline as tpipe
from zaftpu_torch.kernels import melfft as tmelfft
from zaftpu_torch.kernels import melfused as tmelfused
from zaftpu_torch.kernels import rfft as trfft
from zaftpu_torch.sharding import (initialize_distributed, make_mesh,
                                   spectrogram_sharded)

# WL, a hop that divides it (zaftpu's kernel needs one), sampling rate: 15
# (below the stores' rule: the GEMM), an odd prime, an odd 17-smooth one,
# Bluestein at the static block (262: M 131, P 288), 10 ms at 44.1 kHz
# (441 = 3^2 7^2), 25 ms at 22.05 kHz (551 = 19 29), 30 ms (1,323), Bluestein
# at 4,096 values (2,062: M 1,031, P 2,304), 50 ms (2,205: the dynamic
# block) and the largest half with a prime above 127 (4,078: P 4,096).
ZAFTPU_CASES = [(15, 5, 8000), (17, 17, 8000), (255, 85, 16000),
                (262, 131, 16000), (441, 147, 44100), (551, 29, 22050),
                (1323, 441, 44100), (2062, 1031, 44100), (2205, 441, 44100),
                (4078, 2039, 44100)]
# An odd frame count, two rows.
FRAMES, ROWS = 7, 2
# Windows of every layout: even with a smooth half (the static path), odd
# packed in the static and the dynamic block, Bluestein with an even and an
# odd N in each block (131: P 288; 393: P 800; 1,031: P 2,304; 2,039 and
# 4,078: P 4,096; 3,093: P 6,400, the 8,192-value block), and the ends.
ORACLE_WINDOWS = [16, 17, 131, 255, 262, 393, 441, 551, 1031, 1323, 2039,
                  2048, 2062, 2205, 3093, 4078, 4095, 4096]


@pytest.fixture(autouse=True)
def levers(monkeypatch):
    """The front ends' levers start unset."""
    for name in ("ZAFTPU_FFT", "ZAFTPU_PRECISION", "ZAFTPU_MELFUSE"):
        monkeypatch.delenv(name, raising=False)


def _signal(wl, step, t, seed, rows=ROWS):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, (t - 1) * step + wl)).astype(
        np.float32)


def _oracle_bins(padded, win, wl, step, t):
    """Float64 magnitudes of bins 1..WL//2 of the windowed frames."""
    frames = np.lib.stride_tricks.sliding_window_view(
        padded.astype(np.float64), wl, axis=-1)[..., ::step, :][..., :t, :]
    return np.abs(np.fft.rfft(frames * win, axis=-1))[..., 1:wl // 2 + 1]


def _table(fbank, dtype=torch.float32):
    return tmelfft.device_table(tmelfft.filterbank_table(fbank), "cpu", dtype)


def _fbank(sr, wl):
    """The reference filterbank at min(40, WL/4) mels where its
    construction takes the window (its rounded band edges refuse some odd
    ones), else a seeded random one of that shape, a fifth of it nonzero."""
    mels = min(40, wl // 4)
    try:
        return zmel.melfilterbank(sr, wl, mels)
    except ValueError:
        rng = np.random.default_rng(wl)
        fb = rng.random((mels, wl // 2))
        fb[rng.random(fb.shape) < 0.8] = 0.0
        return fb


@pytest.mark.parametrize("kind", ["spec", "mel", "power"])
@pytest.mark.parametrize("wl,step,sr", ZAFTPU_CASES)
def test_stores_match_zaftpu(wl, step, sr, kind):
    """The stores' plain versions (below 16, B8's and B9's GEMM plain
    versions, which the route takes there) on a batch of two rows in one
    call: the first row against zaftpu's spec_rows and mel_rows (one row a
    call) at tests/test_torch_mel_fft.py's tolerance (_gemm_close: 2e-6 of
    max and of each value), with the float64 DFT beside it, the second
    bit-equal to a call on that row alone."""
    padded = _signal(wl, step, FRAMES, wl)
    win = hamming(wl).astype(np.float32)
    x, w = torch.from_numpy(padded), torch.from_numpy(win)
    mag = _oracle_bins(padded, win.astype(np.float64), wl, step, FRAMES)
    fbank = _fbank(sr, wl)
    fbank_t = np.ascontiguousarray(fbank.T.astype(np.float32))
    calls = (tmelfft.spec_rows_fft_plain.calls,
             tmelfft.mel_rows_fft_plain.calls,
             tmelfused.spec_rows_plain.calls, tmelfused.mel_rows_plain.calls)
    if kind == "spec":
        ref = zmelfused.spec_rows(jnp.asarray(padded[0]), jnp.asarray(win),
                                  wl, step, FRAMES, interpret=True)
        oracle = mag
        if tmelfft.fits(wl):
            plain = tmelfft.spec_rows_fft_plain
            store = tmelfft.spec_rows_fft
        else:
            plain = tmelfused.spec_rows_plain
            store = tmelfused.spec_rows
        rest = (w, wl, step, FRAMES)
    else:
        power = kind == "power"
        ref = zmelfused.mel_rows(jnp.asarray(padded[0]), jnp.asarray(win),
                                 jnp.asarray(fbank_t), wl, step, FRAMES,
                                 power, interpret=True)
        oracle = (mag * mag if power else mag) @ fbank.T
        if tmelfft.fits(wl):
            plain = tmelfft.mel_rows_fft_plain
            fb = _table(fbank)
            store = tmelfft.mel_rows_fft
        else:
            plain = tmelfused.mel_rows_plain
            fb = torch.from_numpy(fbank_t)
            store = tmelfused.mel_rows
        rest = (w, fb, wl, step, FRAMES, power)
    mine = store(x, *rest)
    after = (tmelfft.spec_rows_fft_plain.calls,
             tmelfft.mel_rows_fft_plain.calls,
             tmelfused.spec_rows_plain.calls, tmelfused.mel_rows_plain.calls)
    assert [b - a for a, b in zip(calls, after)] == [
        int(f is plain) for f in (tmelfft.spec_rows_fft_plain,
                                  tmelfft.mel_rows_fft_plain,
                                  tmelfused.spec_rows_plain,
                                  tmelfused.mel_rows_plain)]
    ref = np.asarray(ref)
    assert mine.shape == (ROWS, *ref.shape) and mine.dtype == torch.float32
    _gemm_close(mine[0].numpy(), ref, oracle[0])
    assert torch.equal(mine[1], store(x[1], *rest))


@pytest.mark.parametrize("wl", ORACLE_WINDOWS)
def test_stores_against_float64_dft(wl, capsys):
    """Both stores' float32 plain versions within 1e-6 of max of a float64
    numpy DFT (the fft stores' tolerance, tests/test_torch_mel_fft.py), at
    a hop that does not divide the window, two rows and an odd frame
    count; each window's error is printed beside the GEMM route's (B8's
    plain version on the same input). In float64 they compute in float64:
    within 1e-12 of max."""
    step, t = wl // 3 + 1, FRAMES
    padded = _signal(wl, step, t, wl + 1)
    win = hamming(wl).astype(np.float32)
    x, w = torch.from_numpy(padded), torch.from_numpy(win)
    mag = _oracle_bins(padded, win.astype(np.float64), wl, step, t)
    scale = np.abs(mag).max()
    spec = tmelfft.spec_rows_fft(x, w, wl, step, t).numpy()
    gemm = tmelfused.spec_rows(x, w, wl, step, t).numpy()
    err, gemm_err = (float(np.abs(a - mag).max() / scale)
                     for a in (spec, gemm))
    with capsys.disabled():
        print(f"\nWL {wl} {trfft.layout(wl)}: spec store {err:.3g}, GEMM "
              f"route {gemm_err:.3g} of max")
    assert spec.shape == mag.shape and err <= 1e-6
    fbank = _fbank(44100, wl)
    for power in (False, True):
        oracle = (mag * mag if power else mag) @ fbank.T
        mel = tmelfft.mel_rows_fft(x, w, _table(fbank), wl, step, t,
                                   power).numpy()
        np.testing.assert_allclose(mel, oracle, rtol=0,
                                   atol=1e-6 * np.abs(oracle).max())
    spec64 = tmelfft.spec_rows_fft(x.double(), w.double(), wl, step,
                                   t).numpy()
    np.testing.assert_allclose(spec64, mag, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("wl", [441, 1031, 2205])
def test_odd_window_frames_stand_alone(wl):
    """At an odd window (441 in the static block, 1,031 by Bluestein,
    2,205 in the 4,096-value block) each frame's bins equal those of a call
    on that frame alone, bit for bit, whichever frame a call starts at."""
    step, t = wl // 4 + 1, 5
    x = torch.from_numpy(_signal(wl, step, t, 5, rows=1)[0])
    w = torch.from_numpy(hamming(wl).astype(np.float32))
    spec = tmelfft.spec_rows_fft(x, w, wl, step, t)
    for r in range(t):
        frame = x[r * step:r * step + wl]
        assert torch.equal(spec[r:r + 1],
                           tmelfft.spec_rows_fft(frame, w, wl, step, 1))
    assert torch.equal(spec[1:], tmelfft.spec_rows_fft(x[step:], w, wl, step,
                                                       t - 1))


# Five disjoint frames (the hop is the window): loud, silent, -80 dB, loud,
# loud.
QUIET_GAINS = (1.0, 0.0, 1e-4, 1.0, 1.0)


@pytest.mark.parametrize("wl", [441, 1031, 2205])
def test_quiet_frame_beside_loud_one(wl, capsys):
    """QUIET_GAINS' frames at an odd window: each frame's error against a
    float64 DFT within 1e-6 of that frame's own max (a silent frame's
    exactly zero), as the GEMM route's (B8's plain version, printed
    beside): no frame's bins carry another frame's rounding."""
    rng = np.random.default_rng(wl)
    gains = np.array(QUIET_GAINS)
    padded = (rng.standard_normal((len(gains), wl))
              * gains[:, None]).reshape(-1).astype(np.float32)
    win = hamming(wl).astype(np.float32)
    t = len(gains)
    mag = _oracle_bins(padded, win.astype(np.float64), wl, wl, t)
    x, w = torch.from_numpy(padded), torch.from_numpy(win)
    store = tmelfft.spec_rows_fft(x, w, wl, wl, t).numpy()
    gemm = tmelfused.spec_rows(x, w, wl, wl, t).numpy()
    own = mag.max(axis=-1)
    errs = [np.abs(a - mag).max(axis=-1) for a in (store, gemm)]
    with capsys.disabled():
        for f in range(t):
            print(f"\nWL {wl} frame {f} (gain {QUIET_GAINS[f]}): store "
                  f"{errs[0][f]:.3g}, GEMM route {errs[1][f]:.3g} (frame "
                  f"max {own[f]:.3g})", end="")
    assert (errs[0] <= 1e-6 * own).all()
    assert errs[0][1] == 0.0 and errs[1][1] == 0.0


@pytest.mark.parametrize("wl", [441, 1031])
def test_mfcc_at_a_silence_boundary_matches_zaftpu(wl):
    """mfcc of noise, digital silence, -80 dB noise and noise again at an
    odd window and a hop of 147: the frames at each boundary (a silent
    frame beside sound) match zaftpu at tests/test_torch_mel.py's
    tolerance, as every other frame does."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(7 * wl), np.zeros(7 * wl),
                        1e-4 * rng.standard_normal(6 * wl),
                        rng.standard_normal(3 * wl)]).astype(np.float32)
    w = hamming(wl).astype(np.float32)
    fbank = _fbank(44100, wl)
    calls = tmelfft.mel_rows_fft_plain.calls
    mine = zaftpu_torch.mfcc(torch.from_numpy(x), w, 147, fbank, 20).numpy()
    assert tmelfft.mel_rows_fft_plain.calls == calls + 1
    ref = np.asarray(zaftpu.mfcc(x, w, 147, fbank, 20))
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, atol=5e-4)


@pytest.mark.parametrize("wl", [262, 441, 2062, 3093])
def test_batched_rows_bit_equal_to_a_loop(wl):
    """A (2, 3, L) signal through both stores' plain versions equals each
    row alone, bit for bit, at each Bluestein and packed layout."""
    step, t = wl // 2, 5
    rng = np.random.default_rng(wl)
    x = torch.from_numpy(rng.standard_normal(
        (2, 3, (t - 1) * step + wl)).astype(np.float32))
    w = torch.from_numpy(hamming(wl).astype(np.float32))
    table = _table(_fbank(44100, wl))
    spec = tmelfft.spec_rows_fft(x, w, wl, step, t)
    mel = tmelfft.mel_rows_fft(x, w, table, wl, step, t, True)
    assert spec.shape == (2, 3, t, wl // 2)
    assert mel.shape == (2, 3, t, table.number_mels)
    for i in range(2):
        for j in range(3):
            assert torch.equal(spec[i, j], tmelfft.spec_rows_fft(
                x[i, j], w, wl, step, t))
            assert torch.equal(mel[i, j], tmelfft.mel_rows_fft(
                x[i, j], w, table, wl, step, t, True))


def test_many_mels_take_the_store():
    """The number of mels picks no path: a 300-row filterbank at WL 262
    (Bluestein) goes through the mel store and matches zaftpu in float64."""
    fb = np.random.default_rng(5).random((300, 131))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4000))
    calls = tmelfft.mel_rows_fft_plain.calls
    got = zaftpu_torch.melspectrogram(x, hamming(262), 131, fb)
    assert tmelfft.mel_rows_fft_plain.calls == calls + 1
    ref = np.asarray(zaftpu.melspectrogram(x.numpy(), hamming(262), 131, fb))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)


def test_bluestein_lengths_and_tables():
    """The Bluestein lengths this PR names, and the tables: the chirp is
    exp(-i pi (j^2 mod 2M) / M) and B / P's inverse FFT gives back the
    wrapped chirp b (float64, to 1e-12)."""
    assert trfft.layout(262) == (False, 131, 288)
    assert trfft.layout(2062) == (False, 1031, 2304)
    assert trfft.layout(4078) == (False, 2039, 4096)
    assert trfft.layout(3093) == (True, 3093, 6400)
    assert trfft.layout(1323) == (True, 1323, 0)
    assert trfft.layout(2048) == (False, 1024, 0)
    for n in (262, 393, 2062, 3093, 4078):
        lay = trfft.layout(n)
        assert lay.p >= 2 * lay.m - 1 and trfft._factors(lay.p)[1] == 1
        assert lay.p <= next(b for b in trfft.BLOCKS if b >= 2 * lay.m - 1)
        tab = trfft._store_tables(n, "float64")
        assert tab.shape == (n + 2 * lay.p + lay.m, 2)
        np.testing.assert_array_equal(tab[:n], trfft._twiddles(n, "float64"))
        chirp = tab[n + lay.p:n + lay.p + lay.m]
        j = np.arange(lay.m)
        np.testing.assert_allclose(
            chirp[:, 0] + 1j * chirp[:, 1],
            np.exp(-1j * np.pi * j.astype(float) ** 2 / lay.m), atol=1e-9)
        big = tab[n + lay.p + lay.m:]
        b = np.fft.ifft((big[:, 0] + 1j * big[:, 1]) * lay.p)
        c = chirp[:, 0] - 1j * chirp[:, 1]
        np.testing.assert_allclose(b[:lay.m], c, atol=1e-12)
        np.testing.assert_allclose(b[lay.p - lay.m + 1:], c[:0:-1],
                                   atol=1e-12)
        np.testing.assert_allclose(b[lay.m:lay.p - lay.m + 1], 0, atol=1e-12)


@pytest.mark.parametrize("dial", ["highest", "split4", "high", "default"])
def test_route_takes_the_stores_at_every_window(dial, monkeypatch):
    """melfused.route gives "fft" at every window from 16 to 4,096 on
    every dial with no lever set, float32 and float64; below 16 and above
    4,096 it keeps its route (the GEMM kernels or, under split4, the split
    path; the split path above 4,096)."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    for dtype in (torch.float32, torch.float64):
        assert all(tmelfused.route(dtype, wl) == "fft"
                   for wl in range(16, 4097))
        assert tmelfused.route(dtype, 4097) == "split"
    below = "split" if dial == "split4" else "kernel"
    assert all(tmelfused.route(torch.float32, wl) == below
               for wl in range(2, 16))
    assert tmelfused.route(torch.float64, 15) == "kernel"


@pytest.mark.parametrize("lever,value,exact,split4", [
    ("ZAFTPU_FFT", "matmul", "kernel", "split"),
    ("ZAFTPU_MELFUSE", "0", "split", "split"),
    ("ZAFTPU_MELFUSE", "1", "fft", "fft")])
@pytest.mark.parametrize("dial", ["highest", "split4"])
def test_route_levers_at_every_window(lever, value, exact, split4, dial,
                                      monkeypatch):
    """ZAFTPU_FFT=matmul keeps the GEMM kernels (the split path under
    split4) and ZAFTPU_MELFUSE=0 the split path at every window;
    ZAFTPU_MELFUSE=1 keeps the stores."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    monkeypatch.setenv(lever, value)
    want = split4 if dial == "split4" else exact
    assert {tmelfused.route(torch.float32, wl)
            for wl in range(16, 4097)} == {want}


@pytest.mark.parametrize("wl,step", [(1323, 441), (2062, 512)])
def test_public_functions_match_zaftpu(golden, wl, step):
    """spectrogram, melspectrogram and mfcc at the 30-ms window (1,323,
    packed) and at 2,062 / 512 (Bluestein, a hop that does not divide the
    window) through the stores' plain versions, against zaftpu in float32
    at tests/test_torch_mel.py's tolerances."""
    x32 = golden["signal"].astype(np.float32)
    w32 = hamming(wl).astype(np.float32)
    fbank = zaftpu_torch.melfilterbank(44100, wl, 40)
    x = torch.from_numpy(x32)
    calls = (tmelfft.spec_rows_fft_plain.calls,
             tmelfft.mel_rows_fft_plain.calls)
    spec = zaftpu_torch.spectrogram(x, w32, step).numpy()
    mel = zaftpu_torch.melspectrogram(x, w32, step, fbank).numpy()
    mf = zaftpu_torch.mfcc(x, w32, step, fbank, 20).numpy()
    assert (tmelfft.spec_rows_fft_plain.calls,
            tmelfft.mel_rows_fft_plain.calls) == (calls[0] + 1, calls[1] + 2)
    for mine, ref in ((spec, zspectrogram(x32, w32, step)),
                      (mel, zaftpu.melspectrogram(x32, w32, step, fbank))):
        ref = np.asarray(ref)
        assert mine.shape == ref.shape
        np.testing.assert_allclose(
            mine, ref, rtol=2e-6, atol=4e-6 * max(1.0, float(
                np.abs(mine).max())))
    np.testing.assert_allclose(
        mf, np.asarray(zaftpu.mfcc(x32, w32, step, fbank, 20)), atol=5e-4)


def test_streaming_spectrogram_bit_equal_to_whole(golden, tmp_path):
    """streaming_spectrogram at WL 1,323 / hop 441 in blocks of 39 frames
    equals spectrogram of the same decoded signal, bit for bit."""
    wl, step = 1323, 441
    data = (golden["signal"] * 32767).astype(np.int16)
    path = tmp_path / "sig.wav"
    scipy.io.wavfile.write(path, 44100, data)
    win = hamming(wl)
    whole = zaftpu_torch.spectrogram(
        torch.from_numpy((data / 32768.0).astype(np.float32)),
        win.astype(np.float32), step).numpy()
    calls = tmelfft.spec_rows_fft_plain.calls
    streamed = tpipe.streaming_spectrogram(str(path), win, step,
                                           block_frames=39, device="cpu")
    assert tmelfft.spec_rows_fft_plain.calls > calls + 1
    assert streamed.shape == whole.shape
    np.testing.assert_array_equal(streamed, whole)


def test_sharded_spectrogram_one_rank_bit_equal_to_whole(golden, tmp_path):
    """spectrogram_sharded at WL 1,323 / hop 441 on a one-rank gloo world
    (this process) equals spectrogram of the same tensor, bit for bit."""
    wl, step = 1323, 441
    x = torch.from_numpy(golden["signal"].astype(np.float32))
    win = hamming(wl).astype(np.float32)
    whole = zaftpu_torch.spectrogram(x, win, step)
    assert not dist.is_initialized()
    initialize_distributed(device="cpu",
                           init_method=f"file://{tmp_path}/store", rank=0,
                           world_size=1)
    try:
        got = spectrogram_sharded(x, win, step, make_mesh(1))
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, whole)
