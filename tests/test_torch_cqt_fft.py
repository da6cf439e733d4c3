"""zaftpu_torch's spectral CQT kernel (kernels/cqtfft.py, csrc/cqtfft.cu) on
the CPU: the shape rule, the kernel's table and its band form, the split
list and the clusters' placement at L 65,536 (two blocks) and 131,072
(four), the plain version
against zaftpu's slab kernel (Pallas interpret mode) or its float32 CQT,
the float64 oracle and B10's plain slab loop, cqtspectrogram /
cqtchromagram through it against zaftpu and the goldens, batching, the
dispatch on every scheme and dial, the device table's cache and the CUDA
wrapper's refusals. The kernel itself runs on the card
(tests/test_torch_cuda.py, chip_smoke.py; scripts/cuda_cpu_rehearsal.py
--cqt runs its source on the CPU).

Geometries: L 2,048 (8 kHz, 12 bins per octave, 110-880 Hz: hop 320,
F 36), L 4,096 (22.05 kHz, 12 per octave, 110-3,520 Hz: hop 882, F 60) and
CqtConfig() (44.1 kHz, 24 per octave, 55-3,520 Hz: L 32,768, hop 1,764,
F 144); L 65,536 from 8 kHz, 12 per octave, 3-12 Hz (F 24), and from 44.1
kHz, 24 per octave, 27.5-3,520 Hz (F 168); L 131,072 from 8 kHz, 12 per
octave, 1.5-6 Hz (F 24); L 262,144 from 8 kHz, 12 per octave, 0.75-3 Hz
(F 24), past the kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import zaftpu
from zaftpu.pallas import cqtslab as zcqtslab
from zaftpu.transforms import cqt as zcqt
import zaftpu_torch
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import cqtfft as tcqtfft
from zaftpu_torch.kernels import cqtslab as tcqtslab
from zaftpu_torch.kernels import rfft as trfft
from zaftpu_torch.transforms import cqt as tcqt

G2048 = (8000, 12, 110.0, 880.0)
G4096 = (22050, 12, 110.0, 3520.0)
GREF = (44100, 24, 55.0, 3520.0)
G65536 = (8000, 12, 3.0, 12.0)
GWIDE = (44100, 24, 27.5, 3520.0)
G131072 = (8000, 12, 1.5, 6.0)
G262144 = (8000, 12, 0.75, 3.0)
GEOMETRIES = {"L2048": G2048, "L4096": G4096, "CqtConfig": GREF}


@pytest.fixture(autouse=True)
def cache_dir(tmp_path, monkeypatch):
    """Every kernel built here goes to an empty disk cache, and the
    environment's levers start unset."""
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path))
    for name in ("ZAFTPU_FFT", "ZAFTPU_PRECISION", "ZAFTPU_CQT_SCHEME"):
        monkeypatch.delenv(name, raising=False)


def _padded(kern, sr, seconds, seed, lead=()):
    """A signal padded as cqtspectrogram pads it, its hop and frame
    count."""
    step = round(sr / 25)
    n = int(sr * seconds)
    length = kern.fft_length
    x = np.random.default_rng(seed).standard_normal((*lead, n)).astype(
        np.float32)
    pad_front = -(-(length - step) // 2)
    padded = np.pad(x, [(0, 0)] * len(lead) + [(pad_front, length)])
    return padded, step, n // step


def _table(kern):
    return tcqtfft.device_table(tcqtfft.kernel_table(kern), "cpu")


def _foreign(kind):
    """A dense random kernel over every column of L 512, and the L 2048
    kernel with its even rows' bands moved above L/2 (column c to L - c)."""
    rng = np.random.default_rng(5)
    if kind == "dense":
        k = (rng.standard_normal((10, 512))
             + 1j * rng.standard_normal((10, 512))) / 512
        k[rng.random(k.shape) < 0.4] = 0
        return k
    k = tcqt.cqtkernel(*G2048).kernel.copy()
    k[::2] = np.roll(k[::2, ::-1], 1, axis=1)
    return k


@pytest.mark.parametrize("length", [16, 64, 2048, 32768])
def test_twiddle_table_turns_by_exact_quarters(length):
    """The kernel's twiddle table: each quarter is the one before it times
    -i exactly, the first quarter is rfft._twiddles' first quarter, and the
    table differs from rfft._twiddles only in the near-zero entries at L/4,
    L/2 and 3L/4, by under 3e-8, and from W_L^j by under 3e-8."""
    tab = tcqtfft._twiddles(length)
    q = length // 4
    c, s = tab[:q, 0], tab[:q, 1]
    np.testing.assert_array_equal(tab[q:2 * q], np.stack([s, -c], -1))
    np.testing.assert_array_equal(tab[2 * q:3 * q], np.stack([-c, -s], -1))
    np.testing.assert_array_equal(tab[3 * q:], np.stack([-s, c], -1))
    ref = trfft._twiddles(length)
    np.testing.assert_array_equal(tab[:q], ref[:q])
    differ = np.nonzero((tab != ref).any(axis=-1))[0]
    assert set(differ) <= {q, 2 * q, 3 * q}
    assert np.abs(tab - ref).max() < 3e-8
    exact = np.exp(-2j * np.pi * np.arange(length) / length)
    assert max(np.abs(tab[:, 0] - exact.real).max(),
               np.abs(tab[:, 1] - exact.imag).max()) < 3e-8


def test_fits_is_its_definition():
    """A power of two from 16 to 131,072: fourteen lengths, one block a
    frame up to 32,768, a cluster of two at 65,536 and of four at
    131,072."""
    got = [n for n in range(1, 300000) if tcqtfft.fits(n)]
    assert got == [2 ** p for p in range(4, 18)]
    assert [tcqtfft.cluster_size(n) for n in got] == [1] * 12 + [2, 4]


@pytest.mark.parametrize("length", [2048, 32768, 65536, 131072, 262144,
                                    3000])
@pytest.mark.parametrize("fft", [None, "auto", "native", "matmul"])
def test_applies_follows_zaftpu_fft(fft, length, monkeypatch):
    """ZAFTPU_FFT=matmul turns the rule off; auto (the default) and native
    follow it."""
    if fft is not None:
        monkeypatch.setenv("ZAFTPU_FFT", fft)
    assert tcqtfft.applies(length) is (tcqtfft.fits(length)
                                       and fft != "matmul")


@pytest.mark.parametrize("name", list(GEOMETRIES) + ["dense", "high"])
def test_table_holds_exactly_the_kernels_nonzeros(name):
    """Row by row in ascending column order, each nonzero's bin, a
    conjugate flag exactly for the columns above L/2 (read at bin L - c),
    and its value rounded once to complex64."""
    dense = (tcqt.cqtkernel(*GEOMETRIES[name]).kernel if name in GEOMETRIES
             else _foreign(name))
    f, length = dense.shape
    tab = tcqtfft.kernel_table(dense)
    assert tab.fft_length == length and tab.rowptr.dtype == np.int32
    assert tab.rowptr[0] == 0 and tab.rowptr[-1] == np.count_nonzero(dense)
    assert np.all(np.diff(tab.rowptr) == np.count_nonzero(dense, axis=1))
    assert np.all((tab.bins >= 0) & (tab.bins <= length // 2))
    rebuilt = np.zeros((f, length), np.complex64)
    for i in range(f):
        lo, hi = tab.rowptr[i], tab.rowptr[i + 1]
        cols = np.where(tab.conj[lo:hi], length - tab.bins[lo:hi],
                        tab.bins[lo:hi])
        assert np.all(np.diff(cols) > 0)
        assert np.array_equal(tab.conj[lo:hi], cols > length // 2)
        rebuilt[i, cols] = tab.values[lo:hi]
    np.testing.assert_array_equal(rebuilt, dense.astype(np.complex64))
    assert bool(tab.conj.any()) is (name in ("dense", "high"))
    # The CqtKernel and its dense array give the same table.
    if name in GEOMETRIES:
        again = tcqtfft.kernel_table(tcqt.cqtkernel(*GEOMETRIES[name]))
        for a, b in zip(tab[:4], again[:4]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["L2048", "dense", "high"])
def test_conjugate_reads_equal_the_time_domain_operator(name):
    """In float64, the table's product with each frame's half spectrum
    (conj X[L - c] for a column c above L/2) equals the frames' contraction
    with the time-domain operator FFT(K rows) that _finalize_kernel builds
    (transforms/cqt.py): the identity the kernel rests on."""
    dense = (tcqt.cqtkernel(*G2048).kernel if name == "L2048"
             else _foreign(name))
    f, length = dense.shape
    frames = np.random.default_rng(3).standard_normal((7, length))
    half = np.fft.rfft(frames, axis=-1)
    tab = tcqtfft.kernel_table(dense)
    got = np.zeros((7, f), complex)
    for i in range(f):
        lo, hi = tab.rowptr[i], tab.rowptr[i + 1]
        x = half[:, tab.bins[lo:hi]]
        x = np.where(tab.conj[lo:hi], np.conj(x), x)
        got[:, i] = x @ dense[i, np.where(tab.conj[lo:hi],
                                          length - tab.bins[lo:hi],
                                          tab.bins[lo:hi])]
    ref = frames @ tcqt._finalize_kernel(dense).time_kernel.T
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()


@pytest.mark.parametrize("geometry,seconds", [(G2048, 2.0), (G4096, 0.7)])
def test_plain_matches_zaftpu_slab_kernel(geometry, seconds):
    """The plain version against zaftpu's exact slab kernel (B10's
    magnitudes_in_trace in interpret mode) on the same seeded float32
    signal: two float32 computations of one function, within 2e-6 of
    max."""
    kern = zcqt.cqtkernel(*geometry)
    padded, step, t = _padded(kern, geometry[0], seconds, 31)
    length, f = kern.fft_length, kern.number_frequencies
    key = ("test_torch_cqt_fft",) + geometry
    zcqtslab.register_kernel(
        key, np.ascontiguousarray(kern.time_kernel.real.T).astype(np.float32),
        np.ascontiguousarray(kern.time_kernel.imag.T).astype(np.float32))
    ref = np.asarray(zcqtslab.cqt_magnitudes(
        jnp.asarray(padded), key, step, length, t, f, block=16,
        interpret=True))
    calls = tcqtfft.cqt_magnitudes_fft_plain.calls
    mine = tcqtfft.cqt_magnitudes_fft(
        torch.from_numpy(padded), _table(tcqt.cqtkernel(*geometry)), step,
        length, t)
    assert tcqtfft.cqt_magnitudes_fft_plain.calls == calls + 1
    assert mine.shape == ref.shape == (t, f) and mine.dtype == torch.float32
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


def _oracle(kern, padded, step, t, rounded=False):
    """The float64 path (transforms/cqt._cqt_apply) on the same signal;
    ``rounded``: with the kernel's values rounded to complex64 as the
    table holds them, so that a float64 run of the plain version meets it
    to float64 rounding."""
    if rounded:
        kern = tcqt._finalize_kernel(
            kern.kernel.astype(np.complex64).astype(np.complex128))
    k_red, cols, mask = tcqt._device_oracle_kernel(kern, torch.device("cpu"))
    return tcqt._cqt_apply(torch.from_numpy(padded).double(), k_red, cols,
                           mask, step, kern.fft_length, t, 1024)


@pytest.mark.parametrize("name,seconds", [("L2048", 3.0), ("L4096", 2.0),
                                          ("CqtConfig", 2.0)])
def test_plain_matches_the_float64_path(name, seconds):
    """float32 within 1e-6 of max of the float64 _cqt_apply (the
    reference's FFT and reduced product); in float64 the plain version is
    that path, on the table's complex64 values, to 1e-13 of max."""
    geometry = GEOMETRIES[name]
    kern = tcqt.cqtkernel(*geometry)
    padded, step, t = _padded(kern, geometry[0], seconds, 37)
    oracle = _oracle(kern, padded, step, t)
    tab = _table(kern)
    mine = tcqtfft.cqt_magnitudes_fft_plain(torch.from_numpy(padded), tab,
                                            step, kern.fft_length, t)
    scale = float(oracle.abs().max())
    assert float((mine.double() - oracle).abs().max()) <= 1e-6 * scale
    mine64 = tcqtfft.cqt_magnitudes_fft_plain(
        torch.from_numpy(padded).double(), tab, step, kern.fft_length, t)
    assert mine64.dtype == torch.float64
    oracle = _oracle(kern, padded, step, t, rounded=True)
    assert float((mine64 - oracle).abs().max()) <= 1e-13 * scale


@pytest.mark.parametrize("kind", ["dense", "high"])
def test_plain_matches_b10_plain_on_foreign_kernels(kind):
    """A dense foreign kernel (every column, 40% zeros) and one with bands
    above L/2: the plain version against B10's plain slab loop within 2e-6
    of max in float32, and in float64 against the float64 path on the
    table's complex64 values to 1e-13."""
    dense = _foreign(kind)
    kern = tcqt._finalize_kernel(dense)
    padded, step, t = _padded(kern, 8000, 1.5, 41)
    f, length = dense.shape
    x = torch.from_numpy(padded)
    mine = tcqtfft.cqt_magnitudes_fft(x, _table(dense), step, length, t)
    ref = tcqtslab.cqt_magnitudes_plain(
        x, torch.from_numpy(tcqtslab.time_ops(kern.time_kernel)), step,
        length, t, f)
    assert mine.shape == ref.shape == (t, f)
    np.testing.assert_allclose(mine.numpy(), ref.numpy(), rtol=0,
                               atol=2e-6 * float(ref.abs().max()))
    oracle = _oracle(kern, padded, step, t, rounded=True)
    mine64 = tcqtfft.cqt_magnitudes_fft(x.double(), _table(dense), step,
                                        length, t)
    assert float((mine64 - oracle).abs().max()) <= 1e-13 * float(
        oracle.abs().max())


@pytest.mark.parametrize("fn", ["cqtspectrogram", "cqtchromagram"])
@pytest.mark.parametrize("name", ["L2048", "L4096"])
def test_f32_entry_points_match_zaftpu(name, fn):
    """cqtspectrogram / cqtchromagram in float32 through the spectral
    kernel's plain version against zaftpu's float32 CQT, at
    tests/test_torch_cqt.py's 2e-6 of max."""
    sr, bins, fmin, fmax = GEOMETRIES[name]
    x = np.random.default_rng(43).standard_normal(int(2.5 * sr)).astype(
        np.float32)
    args = (sr, 25, bins) if fn == "cqtchromagram" else (sr, 25)
    ref = np.asarray(getattr(zaftpu, fn)(x, *args,
                                         zcqt.cqtkernel(sr, bins, fmin,
                                                        fmax)))
    calls = tcqtfft.cqt_magnitudes_fft_plain.calls
    mine = getattr(zaftpu_torch, fn)(torch.from_numpy(x), *args,
                                     tcqt.cqtkernel(sr, bins, fmin, fmax))
    assert tcqtfft.cqt_magnitudes_fft_plain.calls == calls + 1
    assert mine.dtype == torch.float32 and tuple(mine.shape) == ref.shape
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


def test_f64_goldens_stay_on_the_float64_path(golden, signal):
    """A float64 signal keeps the float64 path (the oracle) and meets the
    goldens at 1e-12; the spectral kernel's plain version does not run."""
    calls = tcqtfft.cqt_magnitudes_fft_plain.calls
    cfg = zaftpu_torch.CqtConfig()
    spec = zaftpu_torch.cqtspectrogram(torch.from_numpy(signal), config=cfg)
    chroma = zaftpu_torch.cqtchromagram(torch.from_numpy(signal), config=cfg)
    assert tcqtfft.cqt_magnitudes_fft_plain.calls == calls
    assert spec.dtype == chroma.dtype == torch.float64
    np.testing.assert_allclose(spec.numpy(), golden["cqtspectrogram"],
                               atol=1e-12)
    np.testing.assert_allclose(chroma.numpy(), golden["cqtchromagram"],
                               atol=1e-12)


@pytest.mark.parametrize("name", ["L2048", "L4096"])
def test_batched_equals_rows(name):
    """A (2, 3) batch through one call equals each row's own call bit for
    bit."""
    sr, bins, fmin, fmax = GEOMETRIES[name]
    kern = tcqt.cqtkernel(sr, bins, fmin, fmax)
    x = torch.from_numpy(np.random.default_rng(47).standard_normal(
        (2, 3, int(1.2 * sr))).astype(np.float32))
    spec = zaftpu_torch.cqtspectrogram(x, sr, 25, kern)
    chroma = zaftpu_torch.cqtchromagram(x, sr, 25, bins, kern)
    for i in range(2):
        for j in range(3):
            assert torch.equal(spec[i, j],
                               zaftpu_torch.cqtspectrogram(x[i, j], sr, 25,
                                                           kern))
            assert torch.equal(chroma[i, j],
                               zaftpu_torch.cqtchromagram(x[i, j], sr, 25,
                                                          bins, kern))


def test_frame_blocks_leave_the_result_as_it_is(monkeypatch):
    """The plain version's blocks of frames (here 3 frames a block, the
    last one short) change no value."""
    kern = tcqt.cqtkernel(*G2048)
    padded, step, t = _padded(kern, 8000, 1.3, 53, (2,))
    tab = _table(kern)
    x = torch.from_numpy(padded)
    whole = tcqtfft.cqt_magnitudes_fft_plain(x, tab, step, 2048, t)
    monkeypatch.setattr(tcqtfft, "PLAIN_BLOCK_SAMPLES", 3 * 2048)
    assert torch.equal(
        tcqtfft.cqt_magnitudes_fft_plain(x, tab, step, 2048, t), whole)


def test_fft_planes_match_the_float64_rfft_at_l32768():
    """The passes the plain version shares with the real-FFT kernels, at
    the CQT's 16,384-point FFT (seven radix-4 passes): in float64 they are
    torch.fft.rfft to 1e-13 of max."""
    frames = torch.from_numpy(np.random.default_rng(59).standard_normal(
        (2, 32768)))
    assert trfft.radices(16384) == (4,) * 7
    re, im = trfft.frames_fft_planes(frames, 32768)
    ref = torch.fft.rfft(frames, dim=-1)
    err = torch.maximum((re - ref.real).abs().max(),
                        (im - ref.imag).abs().max())
    assert float(err) <= 1e-13 * float(ref.abs().max())


def _plain_calls():
    return (tcqtfft.cqt_magnitudes_fft_plain.calls,
            tcqtslab.cqt_magnitudes_plain.calls,
            tcqtslab.cqt_magnitudes_split4_plain.calls)


@pytest.mark.parametrize("case", ["rule", "L65536", "L131072", "L262144",
                                  "matmul"])
@pytest.mark.parametrize("scheme", [None, "split4", "exact"])
@pytest.mark.parametrize("precision", [None, "highest", "split4"])
def test_dispatch_on_every_scheme_and_dial(case, scheme, precision,
                                           monkeypatch):
    """On the CPU the float32 CQT takes the spectral kernel's plain version
    at the rule's L (65,536 and 131,072 among them) on every scheme and
    dial, and the exact slab loop at L 262,144 and under ZAFTPU_FFT=matmul;
    nothing launches, and the time-domain operator is built only where the
    slab loop runs."""
    geometry = {"L65536": G65536, "L131072": G131072,
                "L262144": G262144}.get(case, G2048)
    if case == "matmul":
        monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    if precision is not None:
        monkeypatch.setenv("ZAFTPU_PRECISION", precision)
    if scheme is not None:
        monkeypatch.setenv("ZAFTPU_CQT_SCHEME", scheme)
    kern = tcqt._finalize_kernel(tcqt.cqtkernel(*geometry).kernel)
    x = torch.from_numpy(np.random.default_rng(61).standard_normal(
        4000).astype(np.float32))
    before = _plain_calls()
    launches = (tcqtfft.cqt_magnitudes_fft.launches,
                tcqtfft.cqt_magnitudes_fft_cluster.launches,
                tcqtfft.cqt_magnitudes_fft_cluster4.launches,
                tcqtslab.cqt_magnitudes.launches,
                tcqtslab.cqt_magnitudes_split4.launches)
    zaftpu_torch.cqtspectrogram(x, geometry[0], 25, kern)
    zaftpu_torch.cqtchromagram(x, geometry[0], 25, geometry[1], kern)
    spectral = case in ("rule", "L65536", "L131072")
    moved = (2, 0, 0) if spectral else (0, 2, 0)
    assert _plain_calls() == tuple(b + m for b, m in zip(before, moved))
    assert launches == (tcqtfft.cqt_magnitudes_fft.launches,
                        tcqtfft.cqt_magnitudes_fft_cluster.launches,
                        tcqtfft.cqt_magnitudes_fft_cluster4.launches,
                        tcqtslab.cqt_magnitudes.launches,
                        tcqtslab.cqt_magnitudes_split4.launches)
    dtypes = {key[2] for key in tcqt._device_kernels if key[0] == id(kern)}
    assert dtypes == ({"cqt_fft"} if spectral else {torch.float32})


def test_table_is_cached_and_evicted_with_its_kernel():
    """The device table is built once a kernel and device, under its own
    key, and evicting a foreign kernel drops it."""
    sparse = scipy.sparse.csr_matrix(tcqt.cqtkernel(*G2048).kernel)
    kern = tcqt._as_kernel(sparse)
    cpu = torch.device("cpu")
    table = tcqt._device_fft_table(kern, cpu)
    assert tcqt._device_fft_table(kern, cpu) is table
    assert table.fft_length == 2048 and table.number_frequencies == 36
    assert (id(kern), cpu, "cqt_fft") in tcqt._device_kernels
    tcqt._evict_kernel(("ref", id(sparse)))
    assert not [k for k in tcqt._device_kernels if k[0] == id(kern)]


def _bad_call(case):
    """Call the CUDA half with one bad argument (CPU tensors)."""
    kern = tcqt.cqtkernel(*G2048)
    tab = _table(kern)
    step, t = 320, 9
    sig = torch.zeros((t - 1) * step + 2048)
    calls = {
        "f64": lambda: tcqtfft._cqt_magnitudes_fft_cuda(sig.double(), tab,
                                                        step, 2048, t),
        "length": lambda: tcqtfft._cqt_magnitudes_fft_cuda(
            torch.zeros(70000), tab, step, 3000, t),
        "l262144": lambda: tcqtfft._cqt_magnitudes_fft_cuda(
            torch.zeros(270000), tab, step, 262144, 1),
        "table": lambda: tcqtfft._cqt_magnitudes_fft_cuda(sig, tab, step,
                                                          4096, 1),
        "step": lambda: tcqtfft._cqt_magnitudes_fft_cuda(sig, tab, 0, 2048,
                                                         t),
        "frames": lambda: tcqtfft._cqt_magnitudes_fft_cuda(sig, tab, step,
                                                           2048, 0),
        "short": lambda: tcqtfft._cqt_magnitudes_fft_cuda(sig[:-1], tab,
                                                          step, 2048, t),
        "batch": lambda: tcqtfft._cqt_magnitudes_fft_cuda(
            torch.zeros(2048).expand(65536, 2048), tab, step, 2048, 1),
    }
    return calls[case]()


@pytest.mark.parametrize("case", ["f64", "length", "l262144", "table", "step",
                                  "frames", "short", "batch"])
def test_cuda_wrapper_refuses_before_launch(case, monkeypatch):
    """The CUDA half checks dtype, FFT length, table, hop, frame count,
    signal length and grid before it touches the library: float64 raises
    NotImplementedError, the rest ValueError; nothing is launched."""
    def no_library():
        raise AssertionError("the launch was reached")

    monkeypatch.setattr(_build, "library", no_library)
    launches = tcqtfft.cqt_magnitudes_fft.launches
    error = NotImplementedError if case == "f64" else ValueError
    with pytest.raises(error):
        _bad_call(case)
    assert tcqtfft.cqt_magnitudes_fft.launches == launches


def _any_table(name):
    """The KernelTable of a geometry or a foreign kernel: "dense" and "high"
    at L 512 and 2,048; "denseN" a dense random kernel over every column of
    L N (3 rows, half zeros)."""
    if name.startswith("dense") and name != "dense":
        length = int(name[5:])
        rng = np.random.default_rng(11)
        k = (rng.standard_normal((3, length))
             + 1j * rng.standard_normal((3, length))) / length
        k[rng.random(k.shape) < 0.5] = 0
        return tcqtfft.kernel_table(k)
    geometry = {**GEOMETRIES, "L65536": G65536, "wide": GWIDE,
                "L131072": G131072}.get(name)
    if geometry is None:
        return tcqtfft.kernel_table(_foreign(name))
    return tcqtfft.kernel_table(tcqt.cqtkernel(*geometry))


def _decode_split(entries, length):
    """The split list's entries as (bins, positions) lists: one block's
    positions of its Z (k and M - k), or on a cluster of C blocks the
    positions j and H - j (H = M/C) every block holds."""
    m = length // 2
    c = tcqtfft.cluster_size(length)
    bins, positions = [], []
    for e in entries.tolist():
        if c == 1:
            p = e >> 2
            bins += [k for bit, k in ((1, p), (2, m - p)) if e & bit]
            positions.append({p, (m - p) % m})
        else:
            h, j = m // c, e >> 4 * c
            bins += [k for bit, k in enumerate(
                [j + s * h for s in range(c)]
                + [(s + 1) * h - j for s in range(c)]) if e >> bit & 1]
            positions.append({j, (h - j) % h})
    return bins, positions


@pytest.mark.parametrize("name", ["L2048", "L4096", "CqtConfig", "L65536",
                                  "wide", "dense", "high", "dense65536",
                                  "dense32", "dense128", "L131072",
                                  "dense131072"])
def test_split_list_names_each_bin_once(name):
    """The split list names every bin the table reads exactly once, and no
    two entries share a position: each entry's thread reads and writes
    only its own positions, so the split step needs no barrier."""
    tab = _any_table(name)
    entries = tcqtfft.device_table(tab, "cpu").splits.numpy()
    bins, positions = _decode_split(entries, tab.fft_length)
    assert sorted(bins) == np.unique(tab.bins).tolist()
    flat = [p for group in positions for p in group]
    assert len(flat) == len(set(flat))


@pytest.mark.parametrize("name", ["L65536", "wide", "dense65536", "L131072",
                                  "dense131072"])
def test_cluster_slots_hold_every_bin(name):
    """On a cluster (L 65,536: two blocks; 131,072: four) the split step's
    writes, as the kernel makes them from the split list (each X at its
    block's position, the lowest bin read at a position also in each block
    a copy bit names, which is a block whose own bin there is not read and
    whose rows read that bin; X[M] in every side slot), leave every bin's X
    where x_slots says, and each nonzero's code names its bin, conjugate
    flag and exactly the blocks that hold its X; rows are split between the
    blocks by nonzeros, and a cqtkernel table's rows read every X in their
    own block."""
    tab = _any_table(name)
    length = tab.fft_length
    c = tcqtfft.cluster_size(length)
    m = length // 2
    h = m // c
    full = (1 << c) - 1
    dev = tcqtfft.device_table(tab, "cpu")
    needs = tcqtfft.block_needs(tab)
    held = [dict() for _ in range(c)]  # block -> position -> bin
    for e in dev.splits.numpy().tolist():
        j = e >> 4 * c
        q = (h - j) % h
        for side, pos in ((0, j), (c, q)):
            read = {s: (j + s * h if side == 0 else (s + 1) * h - j)
                    for s in range(c) if e >> (side + s) & 1}
            copies = e >> (2 * c + side) & full
            if side and j == 0:  # Nyquist: the side slot of every block
                assert list(read) in ([], [c - 1]) and not copies
                for r in range(c) if read else ():
                    held[r][h] = m
                continue
            for r, k in read.items():
                assert pos not in held[r]
                held[r][pos] = k
            for r in range(c):
                if copies >> r & 1:
                    low = read[min(read)]
                    assert r not in read and needs[r, low]
                    assert pos not in held[r]
                    held[r][pos] = low
    bins = np.unique(tab.bins)
    block, position, holders = tcqtfft.x_slots(bins, length, needs)
    for k, b, p, who in zip(bins, block, position, holders):
        assert held[b][p] == k
        for r in range(c):
            assert bool(held[r].get(p) == k) is bool(who >> r & 1)
    by_bin = dict(zip(bins.tolist(), holders.tolist()))
    codes = dev.index.numpy()
    shift = tcqtfft.CODE_SHIFT
    np.testing.assert_array_equal(codes >> shift, tab.bins)
    np.testing.assert_array_equal(codes & 1, tab.conj)
    np.testing.assert_array_equal(codes >> 1 & (1 << shift - 1) - 1,
                                  [by_bin[k] for k in tab.bins.tolist()])
    f = tab.rowptr.shape[0] - 1
    bounds = [0, *dev.rsplit[:c - 1], f]
    assert bounds == sorted(bounds) and dev.rsplit[c - 1:] == (f,) * (4 - c)
    for b in range(1, c):
        assert abs(int(tab.rowptr[bounds[b]]) - tab.rowptr[-1] * b / c) <= (
            max(np.diff(tab.rowptr)))
    owner = np.searchsorted(bounds, np.repeat(np.arange(f), np.diff(
        tab.rowptr)), side="right") - 1  # each nonzero's block
    local = codes >> (1 + owner) & 1
    for b in range(c):
        np.testing.assert_array_equal(
            needs[b], np.isin(np.arange(m + 1), tab.bins[owner == b]))
    if not name.startswith("dense"):
        assert local.all()
    else:  # a block that does not hold X reads it where it lies
        assert not local.all()


@pytest.mark.parametrize("length", [64, 1024, 65536, 131072])
def test_cluster_fft_plain_equals_the_passes(length):
    """The cluster's placement of the FFT: the passes before the last on
    each residue class mod C apart (C = 2 where the plan ends in a radix-2
    pass, 4 at L 131,072), then the last pass, bit-equal to the plan's
    passes over the whole row (rfft.fft_rows_plain), in float32 and
    float64; at 65,536 and 131,072 the passes of the L 32,768 table serve
    the residue classes bit for bit (W_65536^4i = W_131072^8i =
    W_32768^2i)."""
    rng = np.random.default_rng(length)
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(rng.standard_normal((2, length))).to(dtype)
        tw = tcqtfft.twiddles(length, dtype, "cpu")
        want = trfft.fft_rows_plain(x[..., 0::2], x[..., 1::2], tw, length)
        got = tcqtfft.cluster_fft_plain(x[..., 0::2], x[..., 1::2], tw,
                                        length)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if length > 32768:
        c = length // 32768
        np.testing.assert_array_equal(tcqtfft._twiddles(length)[::2 * c],
                                      tcqtfft._twiddles(32768)[::2])


@pytest.mark.parametrize("geometry", [G65536, G131072],
                         ids=["L65536", "L131072"])
def test_plain_at_l65536_matches_the_float64_path(geometry):
    """At L 65,536 (G65536) and 131,072 (G131072) the plain version within
    1e-6 of max of the float64 _cqt_apply, and in float64 that path on the
    table's complex64 values to 1e-13, as at L <= 32,768."""
    kern = tcqt.cqtkernel(*geometry)
    padded, step, t = _padded(kern, geometry[0], 3.0, 37)
    tab = _table(kern)
    oracle = _oracle(kern, padded, step, t)
    mine = tcqtfft.cqt_magnitudes_fft_plain(torch.from_numpy(padded), tab,
                                            step, kern.fft_length, t)
    scale = float(oracle.abs().max())
    assert float((mine.double() - oracle).abs().max()) <= 1e-6 * scale
    mine64 = tcqtfft.cqt_magnitudes_fft_plain(
        torch.from_numpy(padded).double(), tab, step, kern.fft_length, t)
    oracle = _oracle(kern, padded, step, t, rounded=True)
    assert float((mine64 - oracle).abs().max()) <= 1e-13 * scale


@pytest.mark.parametrize("geometry", [G65536, G131072],
                         ids=["L65536", "L131072"])
@pytest.mark.parametrize("fn", ["cqtspectrogram", "cqtchromagram"])
def test_f32_entry_points_at_l65536_match_zaftpu(fn, geometry):
    """cqtspectrogram / cqtchromagram in float32 at L 65,536 and 131,072
    through the spectral kernel's plain version against zaftpu's float32
    CQT on the CPU (its slab kernel in interpret mode takes some 18 s there
    at 65,536), at 2e-6 of max."""
    sr, bins, fmin, fmax = geometry
    x = np.random.default_rng(43).standard_normal(2 * sr).astype(np.float32)
    args = (sr, 25, bins) if fn == "cqtchromagram" else (sr, 25)
    ref = np.asarray(getattr(zaftpu, fn)(x, *args,
                                         zcqt.cqtkernel(sr, bins, fmin,
                                                        fmax)))
    calls = tcqtfft.cqt_magnitudes_fft_plain.calls
    mine = getattr(zaftpu_torch, fn)(torch.from_numpy(x), *args,
                                     tcqt.cqtkernel(sr, bins, fmin, fmax))
    assert tcqtfft.cqt_magnitudes_fft_plain.calls == calls + 1
    assert mine.dtype == torch.float32 and tuple(mine.shape) == ref.shape
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())
