"""The real-FFT kernel's magnitude and mel stores
(zaftpu_torch/kernels/melfft.py): their plain versions against zaftpu's
spec_rows and mel_rows (Pallas, interpret mode) and a float64 numpy
oracle, the float64 goldens through the front ends' new default route, the
filterbank's CSR table, batching, the CUDA halves' refusals, and the
front ends' route (kernels/melfused.route) on both dials.

The kernel itself runs on the card (tests/test_torch_cuda.py,
chip_smoke.py compare it with these plain versions there).

Shapes: WL 16 (hop 8), 400 (hop 200 for zaftpu's kernel, which needs a
hop that divides the window; Whisper's hop 160 through the front ends),
1,102 (the odd-prime passes 19 and 29), 2,032 (4, 2, 127) and 2048, with
7 to 128 mels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import zaftpu
import zaftpu_torch
from test_torch_kernels import _gemm_close
from zaftpu.core.windows import hamming
from zaftpu.features import mel as zmel
from zaftpu.pallas import melfused as zmelfused
from zaftpu_torch import MelConfig
from zaftpu_torch.features import mel as tmel
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import melfft as tmelfft
from zaftpu_torch.kernels import melfused as tmelfused
from zaftpu_torch.kernels import rfft as trfft

SHAPES = [(16, 8, 37), (400, 200, 61), (1102, 551, 23), (2032, 1016, 9),
          (2048, 1024, 37)]
# WL, hop, T, sampling rate, mels
MEL_CASES = [(16, 8, 37, 8000, 7), (400, 200, 61, 16000, 80),
             (1102, 551, 23, 44100, 40), (2032, 1016, 9, 22050, 128),
             (2048, 1024, 37, 44100, 40)]
WHISPER = MelConfig(sampling_frequency=16000, window_length=400,
                    step_length=160, number_mels=80, window="hann")


@pytest.fixture(autouse=True)
def levers(monkeypatch):
    """The front ends' levers start unset."""
    for name in ("ZAFTPU_FFT", "ZAFTPU_PRECISION", "ZAFTPU_MELFUSE"):
        monkeypatch.delenv(name, raising=False)


def _signal(wl, step, t, seed, lead=()):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((*lead, (t - 1) * step + wl)).astype(
        np.float32)


def _oracle_bins(padded, win, wl, step, t):
    """Float64 magnitudes of bins 1..WL/2 of the windowed frames."""
    frames = np.lib.stride_tricks.sliding_window_view(
        padded.astype(np.float64), wl, axis=-1)[..., ::step, :][..., :t, :]
    return np.abs(np.fft.rfft(frames * win, axis=-1))[..., 1:]


def _table(fbank, dtype=torch.float32):
    return tmelfft.device_table(tmelfft.filterbank_table(fbank), "cpu", dtype)


@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_spec_rows_fft_matches_zaftpu(wl, step, t):
    """The magnitude store's plain version against zaftpu's B8 (its GEMM):
    _gemm_close's float32 tolerance, 2e-6 of max and of each value; and
    against the float64 oracle within 1e-6 of max (the FFT's float32
    rounding; the worst case here is about 3e-7)."""
    padded = _signal(wl, step, t, 21)
    win = hamming(wl).astype(np.float32)
    ref = np.asarray(zmelfused.spec_rows(
        jnp.asarray(padded), jnp.asarray(win), wl, step, t, interpret=True))
    calls = tmelfft.spec_rows_fft_plain.calls
    mine = tmelfft.spec_rows_fft(torch.from_numpy(padded),
                                 torch.from_numpy(win), wl, step, t)
    assert tmelfft.spec_rows_fft_plain.calls == calls + 1
    assert mine.shape == ref.shape == (t, wl // 2)
    assert mine.dtype == torch.float32
    oracle = _oracle_bins(padded, win, wl, step, t)
    _gemm_close(mine.numpy(), ref, oracle)
    np.testing.assert_allclose(mine.numpy(), oracle, rtol=0,
                               atol=1e-6 * np.abs(oracle).max())


@pytest.mark.parametrize("power", [False, True])
@pytest.mark.parametrize("wl,step,t,sr,mels", MEL_CASES)
def test_mel_rows_fft_matches_zaftpu(wl, step, t, sr, mels, power):
    """The mel store's plain version against zaftpu's B9 (its GEMM and
    dense filterbank product) at _gemm_close's float32 tolerance, with the
    float64 oracle beside it; and against that oracle within 1e-6 of max
    (the worst case here is about 4e-7)."""
    padded = _signal(wl, step, t, 22)
    win = hamming(wl).astype(np.float32)
    fbank = zmel.melfilterbank(sr, wl, mels)
    fbank_t = np.ascontiguousarray(fbank.T.astype(np.float32))
    ref = np.asarray(zmelfused.mel_rows(
        jnp.asarray(padded), jnp.asarray(win), jnp.asarray(fbank_t), wl,
        step, t, power, interpret=True))
    calls = tmelfft.mel_rows_fft_plain.calls
    mine = tmelfft.mel_rows_fft(torch.from_numpy(padded),
                                torch.from_numpy(win), _table(fbank), wl,
                                step, t, power)
    assert tmelfft.mel_rows_fft_plain.calls == calls + 1
    assert mine.shape == ref.shape == (t, mels)
    assert mine.dtype == torch.float32
    mag = _oracle_bins(padded, win, wl, step, t)
    oracle = (mag * mag if power else mag) @ fbank.T
    _gemm_close(mine.numpy(), ref, oracle)
    np.testing.assert_allclose(mine.numpy(), oracle, rtol=0,
                               atol=1e-6 * np.abs(oracle).max())


def test_mel_rows_fft_sums_in_the_tables_order():
    """Each mel is its nonzeros' float32 products added to a zero sum in
    ascending column order, bit for bit (a numpy loop over the table; the
    magnitudes from the magnitude store's plain version)."""
    wl, step, t = 512, 128, 9
    padded = torch.from_numpy(_signal(wl, step, t, 23))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    fbank = zmel.melfilterbank(16000, wl, 24)
    table = tmelfft.filterbank_table(fbank)
    mag = tmelfft.spec_rows_fft_plain(padded, win, wl, step, t).numpy()
    want = np.zeros((t, 24), np.float32)
    w32 = table.weights.astype(np.float32)
    for m in range(24):
        for j in range(table.rowptr[m], table.rowptr[m + 1]):
            want[:, m] = want[:, m] + w32[j] * mag[:, table.cols[j]]
    got = tmelfft.mel_rows_fft(padded, win, tmelfft.device_table(table, "cpu"),
                               wl, step, t, False)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dial", ["highest", "split4"])
def test_goldens_through_the_new_route(golden, signal, hamming_window, dial,
                                       monkeypatch):
    """The float64 goldens through spectrogram, melspectrogram and mfcc at
    WL 2048, which now run the magnitude and mel stores' plain versions on
    both dials (float64 never lowers), at tests/test_torch_mel.py's
    tolerances (1e-12; 1e-10 relative and 1e-12; MFCC 1e-10)."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    fb = zaftpu_torch.melfilterbank(44100, 2048, 40)
    x = torch.from_numpy(signal)
    calls = (tmelfft.spec_rows_fft_plain.calls,
             tmelfft.mel_rows_fft_plain.calls)
    spec = zaftpu_torch.spectrogram(x, hamming_window, 1024)
    mel = zaftpu_torch.melspectrogram(x, hamming_window, 1024, fb)
    mf = zaftpu_torch.mfcc(x, hamming_window, 1024, fb, 20)
    assert (tmelfft.spec_rows_fft_plain.calls,
            tmelfft.mel_rows_fft_plain.calls) == (calls[0] + 1, calls[1] + 2)
    assert spec.dtype == mel.dtype == mf.dtype == torch.float64
    np.testing.assert_allclose(spec.numpy(),
                               np.abs(golden["stft"][1:1025]), atol=1e-12)
    np.testing.assert_allclose(mel.numpy(), golden["melspectrogram"],
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(mf.numpy(), golden["mfcc"], atol=1e-10)


def test_whisper_front_end_matches_zaftpu():
    """Whisper's front end (16 kHz, Hann 400 / hop 160, 80 mels) in
    float32 through the new stores against zaftpu's float32 outputs (its
    split path on the CPU): tests/test_torch_mel.py's tolerance (2e-6
    relative, 4e-6 of max) for spectrogram and melspectrogram, MFCC atol
    5e-4 (the log domain)."""
    x = np.random.default_rng(24).standard_normal(16000).astype(np.float32)
    win, step = WHISPER.window_array().astype(np.float32), 160
    fb = WHISPER.filterbank()
    xt = torch.from_numpy(x)
    calls = (tmelfft.spec_rows_fft_plain.calls,
             tmelfft.mel_rows_fft_plain.calls)
    mine = (zaftpu_torch.spectrogram(xt, win, step),
            zaftpu_torch.melspectrogram(xt, config=WHISPER),
            zaftpu_torch.mfcc(xt, config=WHISPER))
    assert (tmelfft.spec_rows_fft_plain.calls,
            tmelfft.mel_rows_fft_plain.calls) == (calls[0] + 1, calls[1] + 2)
    refs = (zaftpu.spectrogram(x, win, step),
            zaftpu.melspectrogram(x, win, step, fb),
            zaftpu.mfcc(x, win, step, fb, WHISPER.number_coefficients))
    for got, ref in zip(mine[:2], refs[:2]):
        ref = np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6,
                                   atol=4e-6 * max(1.0, np.abs(ref).max()))
    np.testing.assert_allclose(mine[2].numpy(), np.asarray(refs[2]),
                               atol=5e-4)


@pytest.mark.parametrize("kind", ["dense", "float32", "sparse", "tensor"])
def test_filterbank_table_holds_the_nonzeros(kind):
    """Nonzeros only, rows in mel order with ascending columns, the
    weights exactly the filterbank's (float64) and, uploaded in float32,
    exactly the values the (WL/2, n_mels) float32 transpose holds
    (features.mel._filterbank_t); the same table from a dense float64 or
    float32 array, a scipy sparse matrix and a tensor."""
    fbank = zaftpu_torch.melfilterbank(44100, 2048, 40)
    given = {"dense": fbank, "float32": fbank.astype(np.float32),
             "sparse": scipy.sparse.csr_matrix(fbank),
             "tensor": torch.from_numpy(fbank)}[kind]
    dense = fbank.astype(np.float32).astype(np.float64) if kind == "float32" \
        else fbank
    table = tmelfft.filterbank_table(given)
    assert table.number_bins == 1024 and table.rowptr.shape == (41,)
    assert table.rowptr.dtype == table.cols.dtype == np.int32
    assert table.rowptr[-1] == table.cols.shape[0] == 1918
    for m in range(40):
        cols = table.cols[table.rowptr[m]:table.rowptr[m + 1]]
        np.testing.assert_array_equal(cols, np.nonzero(dense[m])[0])
        assert np.array_equal(table.weights[table.rowptr[m]:
                                            table.rowptr[m + 1]],
                              dense[m, cols])
    dev = tmelfft.device_table(table, "cpu", torch.float32)
    fbank_t = tmel._filterbank_t(dense, torch.zeros(1, dtype=torch.float32))
    rows = np.repeat(np.arange(40), np.diff(table.rowptr))
    assert torch.equal(dev.weights, fbank_t[table.cols, rows])
    assert dev.pad_cols.shape == dev.pad_weights.shape == (40, 163)
    assert int(dev.counts.max()) == 163 and int(dev.counts.min()) >= 1


def test_filterbank_table_keeps_nan_and_drops_zeros():
    """A NaN weight is a nonzero; zeros, negative zero included, are
    not; an all-zero row is an empty row."""
    fbank = np.zeros((3, 8))
    fbank[0, [1, 5]] = [0.5, np.nan]
    fbank[1, 2] = -0.0
    fbank[2, [0, 7]] = [-1.0, 2.0]
    table = tmelfft.filterbank_table(fbank)
    np.testing.assert_array_equal(table.rowptr, [0, 2, 2, 4])
    np.testing.assert_array_equal(table.cols, [1, 5, 0, 7])
    np.testing.assert_array_equal(table.weights, [0.5, np.nan, -1.0, 2.0])
    dev = tmelfft.device_table(table, "cpu")
    np.testing.assert_array_equal(dev.counts.numpy(), [2, 0, 2])
    assert dev.pad_weights.shape == (3, 2)


def test_filterbank_changed_in_place_is_read_afresh():
    """A filterbank array changed in place between two calls gives the
    second call's values (zaftpu's melspectrogram reads its filterbank on
    each call too): the kept table is compared with the array's values."""
    x = torch.from_numpy(np.random.default_rng(25).standard_normal(
        8000).astype(np.float32))
    win = hamming(512).astype(np.float32)
    fb = zaftpu_torch.melfilterbank(8000, 512, 20).copy()
    first = zaftpu_torch.melspectrogram(x, win, 256, fb)
    fb *= 2.0
    second = zaftpu_torch.melspectrogram(x, win, 256, fb)
    assert torch.equal(second, 2.0 * first)
    np.testing.assert_allclose(
        second.numpy(),
        np.asarray(zaftpu.melspectrogram(x.numpy(), win, 256, fb)),
        rtol=2e-6, atol=4e-6 * float(second.abs().max()))


def test_device_table_is_kept_for_an_equal_filterbank():
    """filterbank_device_table reuses the last table of a shape, device and
    dtype for a filterbank equal to the one it came from (the same array
    or a copy), builds a new one for a changed array, a NaN-bearing one or
    another dtype, and keeps at most MAX_TABLES."""
    fb = zaftpu_torch.melfilterbank(16000, 512, 24).copy()
    get = tmelfft.filterbank_device_table
    first = get(fb, "cpu", torch.float32)
    assert get(fb, "cpu", torch.float32) is first
    assert get(fb.copy(), "cpu", torch.float32) is first
    assert get(fb, "cpu", torch.float64) is not first
    fb[3, 7] += 1.0
    changed = get(fb, "cpu", torch.float32)
    assert changed is not first
    assert float(changed.weights.sum()) == pytest.approx(
        float(first.weights.sum()) + 1.0)
    fb[0, 0] = np.nan
    assert get(fb, "cpu", torch.float32) is not get(fb, "cpu", torch.float32)
    for n in range(1, tmelfft.MAX_TABLES + 3):
        get(np.ones((2, n)), "cpu", torch.float32)
    assert len(tmelfft._TABLES) <= tmelfft.MAX_TABLES


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_non_finite_sample_gives_zaftpus_nans(bad):
    """A NaN or infinite sample: every mel of the two frames it reaches is
    NaN in zaftpu (its dense product forms 0 * inf) and in the port (the
    FFT spreads the sample over every bin, as NaN: inf - inf in the
    butterflies), and every other value finite in both; the MFCCs follow.
    The spectrogram agrees where zaftpu's native FFT gives NaN; for an
    infinite sample it gives +inf where the port's FFT gives NaN."""
    x = np.random.default_rng(26).standard_normal(44100).astype(np.float32)
    x[20000] = bad
    win = hamming(2048).astype(np.float32)
    fb = zaftpu_torch.melfilterbank(44100, 2048, 40)
    xt = torch.from_numpy(x)
    for name, mine, ref in (
            ("mel", zaftpu_torch.melspectrogram(xt, win, 1024, fb),
             zaftpu.melspectrogram(x, win, 1024, fb)),
            ("mfcc", zaftpu_torch.mfcc(xt, win, 1024, fb, 20),
             zaftpu.mfcc(x, win, 1024, fb, 20))):
        mine, ref = mine.numpy(), np.asarray(ref)
        assert np.array_equal(np.isnan(mine), np.isnan(ref)), name
        assert np.isfinite(mine).sum() == np.isfinite(ref).sum(), name
        assert np.isnan(mine[:, [19, 20]]).all(), name
    spec = zaftpu_torch.spectrogram(xt, win, 1024).numpy()
    assert np.isnan(spec[:, [19, 20]]).all()
    assert np.isfinite(np.delete(spec, [19, 20], axis=1)).all()


@pytest.mark.parametrize("power", [False, True])
def test_batched_rows_bit_equal_to_a_loop(power):
    """A (2, 3, L) signal through both stores' plain versions equals each
    row alone, bit for bit."""
    wl, step, t = 400, 160, 21
    padded = torch.from_numpy(_signal(wl, step, t, 27, lead=(2, 3)))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    table = _table(zaftpu_torch.melfilterbank(16000, wl, 80))
    spec = tmelfft.spec_rows_fft(padded, win, wl, step, t)
    mel = tmelfft.mel_rows_fft(padded, win, table, wl, step, t, power)
    assert spec.shape == (2, 3, t, 200) and mel.shape == (2, 3, t, 80)
    for i in range(2):
        for j in range(3):
            assert torch.equal(
                spec[i, j], tmelfft.spec_rows_fft(padded[i, j], win, wl, step,
                                                  t))
            assert torch.equal(
                mel[i, j], tmelfft.mel_rows_fft(padded[i, j], win, table, wl,
                                                step, t, power))


def test_magnitude_store_is_the_half_stores_bins():
    """The magnitude store's plain version is sqrt(re*re + im*im), rooted
    in float64 and rounded once, of the half store's bins 1..WL/2, bit for
    bit; in float64 it is the float64 root."""
    wl, step, t = 1102, 551, 13
    padded = torch.from_numpy(_signal(wl, step, t, 28))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    half = trfft.frames_rfft_fft(padded, win, wl, step, t)[..., 1:]
    p = half.real * half.real + half.imag * half.imag
    spec = tmelfft.spec_rows_fft(padded, win, wl, step, t)
    assert torch.equal(spec, torch.sqrt(p.double()).float())
    half64 = trfft.frames_rfft_fft(padded.double(), win.double(), wl, step,
                                   t)[..., 1:]
    assert torch.equal(
        tmelfft.spec_rows_fft(padded.double(), win.double(), wl, step, t),
        torch.sqrt(half64.real ** 2 + half64.imag ** 2))


def _bad_call(case):
    """Call a CUDA half with one bad argument (CPU tensors)."""
    wl, step, t = 512, 128, 9
    sig = torch.zeros((t - 1) * step + wl)
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    tab = _table(zaftpu_torch.melfilterbank(8000, wl, 20))
    spec, mel = tmelfft._spec_rows_fft_cuda, tmelfft._mel_rows_fft_cuda
    calls = {
        "spec f64": lambda: spec(sig.double(), win, wl, step, t),
        "mel f64": lambda: mel(sig.double(), win, tab, wl, step, t, False),
        "spec window": lambda: spec(torch.zeros(5000), torch.zeros(15),
                                    15, 5, 9),
        "mel window": lambda: mel(torch.zeros(5000), torch.zeros(15),
                                  _table(np.ones((4, 7))), 15, 5, 9,
                                  False),
        "mel table": lambda: mel(sig, win, _table(np.ones((4, 128))), wl,
                                 step, t, False),
        "mel table f64": lambda: mel(sig, win, _table(
            zaftpu_torch.melfilterbank(8000, wl, 20), torch.float64), wl,
            step, t, False),
        "spec short": lambda: spec(sig[:-1], win, wl, step, t),
        "mel short": lambda: mel(sig[:-1], win, tab, wl, step, t, True),
        "spec step": lambda: spec(sig, win, wl, 0, t),
        "spec batch": lambda: spec(torch.zeros(wl).expand(65536, wl), win,
                                   wl, step, 1),
    }
    return calls[case]()


@pytest.mark.parametrize("case", ["spec f64", "mel f64", "spec window",
                                  "mel window", "mel table", "mel table f64",
                                  "spec short", "mel short", "spec step",
                                  "spec batch"])
def test_cuda_halves_refuse_before_launch(case, monkeypatch):
    """The CUDA halves check the dtype (signal and table), the window
    (melfft.fits: 16 to 4,096), the table's bins, the signal's length, the
    hop and the grid before they touch the library: float64 raises
    NotImplementedError, the rest ValueError; nothing is launched or
    counted."""
    def no_library():
        raise AssertionError("the launch was reached")

    monkeypatch.setattr(_build, "library", no_library)
    launches = (tmelfft.spec_rows_fft.launches, tmelfft.mel_rows_fft.launches)
    error = NotImplementedError if "f64" in case else ValueError
    with pytest.raises(error):
        _bad_call(case)
    assert (tmelfft.spec_rows_fft.launches,
            tmelfft.mel_rows_fft.launches) == launches


@pytest.mark.parametrize("lead", [(), (0,), (2,)])
def test_zero_frames_return_empty_without_a_launch(lead, monkeypatch):
    """T = 0 (or no rows) gives an empty float32 output of the right shape
    from the CUDA halves without touching the library."""
    monkeypatch.setattr(_build, "library", lambda: None)
    wl, step = 512, 128
    sig = torch.zeros((*lead, wl))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    tab = _table(zaftpu_torch.melfilterbank(8000, wl, 20))
    for t in ((0, 1) if lead == (0,) else (0,)):
        spec = tmelfft._spec_rows_fft_cuda(sig, win, wl, step, t)
        mel = tmelfft._mel_rows_fft_cuda(sig, win, tab, wl, step, t, True)
        assert spec.shape == (*lead, t, 256) and mel.shape == (*lead, t, 20)
        assert spec.dtype == mel.dtype == torch.float32


def test_plain_version_refuses_a_table_for_another_window():
    wl, step, t = 512, 128, 3
    sig = torch.zeros((t - 1) * step + wl)
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    with pytest.raises(ValueError, match="bins"):
        tmelfft.mel_rows_fft(sig, win, _table(np.ones((4, 128))), wl, step,
                             t, False)


# The route of kernels/melfused.route: twelve rows x both dials. WL 262
# (its half 131 a prime above 127: Bluestein) and 401 (odd, and a prime:
# a complex FFT a frame, by Bluestein) take the stores as the rule's
# windows do; ZAFTPU_FFT=matmul sends 2,062 (Bluestein too) to the GEMMs as
# it does 2048.
ROUTE_ROWS = [
    # (window, ZAFTPU_MELFUSE, ZAFTPU_FFT, exact dial, split4 dial)
    (2048, None, None, "fft", "fft"),
    (2048, "1", None, "fft", "fft"),
    (1102, "auto", None, "fft", "fft"),
    (2048, "0", None, "split", "split"),
    (262, None, None, "fft", "fft"),
    (2048, None, "matmul", "kernel", "split"),
    (262, "1", None, "fft", "fft"),
    (2048, "1", "matmul", "kernel", "kernel"),
    (262, "0", None, "split", "split"),
    (2048, "0", "matmul", "split", "split"),
    (401, None, None, "fft", "fft"),
    (2062, None, "matmul", "kernel", "split"),
]


@pytest.mark.parametrize("wl,melfuse,fft,exact,split4", ROUTE_ROWS)
@pytest.mark.parametrize("dial", ["highest", "split4"])
def test_route_table(wl, melfuse, fft, exact, split4, dial, monkeypatch):
    """Every window from 16 to 4,096 takes the stores on both dials unless
    ZAFTPU_MELFUSE=0; under ZAFTPU_FFT=matmul auto takes B8 / B9 on the
    exact dial and the split path under split4, 1 takes B8 / B9 (B9-s4
    under split4), 0 the split path. float64 follows the exact dial's
    column on both dials."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    for name, value in (("ZAFTPU_MELFUSE", melfuse), ("ZAFTPU_FFT", fft)):
        if value is not None:
            monkeypatch.setenv(name, value)
    assert tmelfused.route(torch.float32, wl) == (
        split4 if dial == "split4" else exact)
    assert tmelfused.route(torch.float64, wl) == exact


_PLAIN = {"spec_rows_fft": tmelfft.spec_rows_fft_plain,
          "mel_rows_fft": tmelfft.mel_rows_fft_plain,
          "spec_rows": tmelfused.spec_rows_plain,
          "mel_rows": tmelfused.mel_rows_plain,
          "mel_rows_split4": tmelfused.mel_rows_split4_plain,
          "frames_rfft_fft": trfft.frames_rfft_fft_plain,
          "frames_rfft": tfused.frames_rfft_plain,
          "frames_rfft_split4": tfused.frames_rfft_split4_plain}


@pytest.mark.parametrize("wl,melfuse,fft,exact,split4", ROUTE_ROWS)
@pytest.mark.parametrize("dial", ["highest", "split4"])
def test_front_ends_follow_the_route(wl, melfuse, fft, exact, split4, dial,
                                     monkeypatch):
    """spectrogram, melspectrogram and mfcc of a float32 signal run the
    plain versions of the route's kernels and no others: the stores; B8
    and B9 (B9-s4 under split4); or the half spectrum of the analysis
    dispatch (the FFT's half store at every window from 16 to 4,096
    unless ZAFTPU_FFT=matmul, else B1 or its twin)."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    for name, value in (("ZAFTPU_MELFUSE", melfuse), ("ZAFTPU_FFT", fft)):
        if value is not None:
            monkeypatch.setenv(name, value)
    route = split4 if dial == "split4" else exact
    if route == "fft":
        want = {"spec_rows_fft", "mel_rows_fft"}
    elif route == "kernel":
        want = {"spec_rows",
                "mel_rows_split4" if dial == "split4" else "mel_rows"}
    elif trfft.half_applies(wl):
        want = {"frames_rfft_fft"}
    else:
        want = {"frames_rfft_split4" if dial == "split4" else "frames_rfft"}
    x = torch.from_numpy(np.random.default_rng(29).standard_normal(
        6000).astype(np.float32))
    win = hamming(wl).astype(np.float32)
    fb = zaftpu_torch.melfilterbank(16000, wl, 20)
    before = {k: f.calls for k, f in _PLAIN.items()}
    zaftpu_torch.spectrogram(x, win, wl // 2)
    zaftpu_torch.melspectrogram(x, win, wl // 2, fb)
    zaftpu_torch.mfcc(x, win, wl // 2, fb, 12)
    assert {k for k, f in _PLAIN.items() if f.calls != before[k]} == want
