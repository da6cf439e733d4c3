"""zaftpu_torch's CQT: the kernel against the reference goldens (bit for
bit, and against zaftpu's arrays), the operator disk cache, foreign
kernels and their device operators, cqtspectrogram / cqtchromagram against
the goldens (float64) and against zaftpu (float32), batching, block
boundaries, ``config=`` and validation.

Mirrors tests/test_cqt.py and the cache tests of tests/test_utils.py. On
the CPU the float32 CQT runs the plain slab loop of
``kernels.cqtslab.cqt_magnitudes``. Every kernel here is built with the
disk cache pointed at a temporary directory, so no cached file stands in
for the port's own build.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse
import torch

import zaftpu
from zaftpu.transforms import cqt as zcqt
from zaftpu.utils import cache as zcache
import zaftpu_torch
from zaftpu_torch import CqtConfig
from zaftpu_torch.kernels import cqtslab as tcqtslab
from zaftpu_torch.transforms import cqt as tcqt
from zaftpu_torch.utils import cache as tcache

SR, OR, FMIN, FMAX, TRES = 44100, 24, 55, 3520, 25
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    """The reference-geometry kernel, built by the port into an empty
    cache directory (the in-memory cache cleared first)."""
    patch = pytest.MonkeyPatch()
    patch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path_factory.mktemp("cache")))
    tcqt._cqtkernel_cached.cache_clear()
    yield tcqt.cqtkernel(SR, OR, FMIN, FMAX)
    patch.undo()


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("ZAFTPU_CACHE", raising=False)
    return tmp_path


# cqtkernel without its in-memory cache: a call always reaches the disk
# cache and, on a miss, the build.
_uncached = tcqt._cqtkernel_cached.__wrapped__


def _golden_kernel(golden, tag):
    ref = np.zeros(tuple(golden[f"{tag}_shape"]), dtype=np.complex128)
    ref[golden[f"{tag}_rows"], golden[f"{tag}_cols"]] = golden[f"{tag}_vals"]
    return ref


def _np(x):
    return x.detach().cpu().numpy()


def test_kernel_shape_and_sparsity(kernel):
    assert kernel.shape == (144, 32768)
    assert (kernel.kernel != 0).sum() == 9450


def test_kernel_bitwise_vs_reference(golden, kernel):
    np.testing.assert_allclose(kernel.kernel,
                               _golden_kernel(golden, "cqt_kernel"),
                               atol=1e-18)


@pytest.mark.parametrize("ssr,sor,sfmin,sfmax", [(22050, 12, 110, 3520),
                                                 (48000, 36, 60, 6000)])
def test_kernel_param_sweep_vs_reference(golden, ssr, sor, sfmin, sfmax,
                                         fresh_cache):
    ref = _golden_kernel(golden, f"cqtk_{ssr}_{sor}_{sfmin}_{sfmax}")
    mine = tcqt.cqtkernel(ssr, sor, sfmin, sfmax)
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine.kernel, ref, atol=1e-18)


def test_time_kernel_and_reduced_form_equal_zaftpu(kernel):
    ref = zcqt.cqtkernel(SR, OR, FMIN, FMAX)
    for name in ("kernel", "columns_low", "columns_high", "reduced_low",
                 "reduced_high", "time_kernel"):
        np.testing.assert_array_equal(getattr(kernel, name),
                                      getattr(ref, name), err_msg=name)


def test_reduced_form_consistent(kernel):
    dense = kernel.kernel
    np.testing.assert_array_equal(dense[:, kernel.columns_low],
                                  kernel.reduced_low)
    np.testing.assert_array_equal(dense[:, kernel.columns_high],
                                  kernel.reduced_high)
    nz = np.nonzero(np.any(dense != 0, axis=0))[0]
    got = np.sort(np.concatenate([kernel.columns_low, kernel.columns_high]))
    np.testing.assert_array_equal(nz, got)


def test_kernel_cached_in_memory(kernel):
    assert tcqt.cqtkernel(SR, OR, FMIN, FMAX) is kernel
    assert tcqt.cqtkernel(float(SR), OR, 55.0, 3520.0) is kernel
    assert CqtConfig().kernel() is kernel


def test_kernel_disk_round_trip(fresh_cache):
    k1 = _uncached(22050.0, 12, 110.0, 880.0)
    files = list(fresh_cache.glob("cqtkernel-*.npz"))
    assert len(files) == 1
    k2 = _uncached(22050.0, 12, 110.0, 880.0)
    assert k2 is not k1
    np.testing.assert_array_equal(k1.kernel, k2.kernel)
    np.testing.assert_array_equal(k1.time_kernel, k2.time_kernel)


def test_cache_disabled_writes_nothing(fresh_cache, monkeypatch):
    monkeypatch.setenv("ZAFTPU_CACHE", "0")
    calls = []

    def build():
        calls.append(1)
        return {"a": np.zeros(1)}

    tcache.cached_operator("op", (), build)
    tcache.cached_operator("op", (), build)
    _uncached(22050.0, 12, 110.0, 880.0)
    assert len(calls) == 2
    assert list(fresh_cache.iterdir()) == []


def test_cached_operator_round_trip_and_corrupt_entry(fresh_cache):
    calls = []

    def build():
        calls.append(1)
        return {"a": np.arange(5.0), "b": np.ones((2, 2), np.complex128)}

    first = tcache.cached_operator("op", (1, 2.5), build)
    second = tcache.cached_operator("op", (1, 2.5), build)
    assert len(calls) == 1
    np.testing.assert_array_equal(first["b"], second["b"])
    tcache.cached_operator("op", (1, 3.5), build)
    assert len(calls) == 2
    path = fresh_cache / tcache._key("op", (1, 2.5))
    path.write_bytes(b"not an npz file")
    again = tcache.cached_operator("op", (1, 2.5), build)
    assert len(calls) == 3
    np.testing.assert_array_equal(again["a"], first["a"])
    with np.load(path) as data:  # rewritten whole
        np.testing.assert_array_equal(data["a"], first["a"])


def test_default_cache_dir_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv("ZAFTPU_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tcache.operator_cache_dir() == str(
        tmp_path / ".cache" / "zaftpu_torch")
    assert os.path.isdir(tmp_path / ".cache" / "zaftpu_torch")
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path / "sub"))
    assert tcache.operator_cache_dir().endswith("sub")
    assert tcache._key("cqtkernel", (1.0,)) == zcache._key("cqtkernel",
                                                           (1.0,))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_and_sparse_kernels_agree(signal, kernel, dtype):
    x = torch.from_numpy(signal.astype(dtype))
    a = tcqt.cqtspectrogram(x, SR, TRES, kernel)
    b = tcqt.cqtspectrogram(x, SR, TRES, kernel.kernel)
    c = tcqt.cqtspectrogram(x, SR, TRES,
                            scipy.sparse.csr_matrix(kernel.kernel))
    assert torch.equal(a, b) and torch.equal(a, c)


def test_foreign_kernels_memoised_and_bounded(fresh_cache):
    small = tcqt.cqtkernel(8000, 12, 110, 880).kernel
    sparse = scipy.sparse.csr_matrix(small)
    assert tcqt._as_kernel(sparse) is tcqt._as_kernel(sparse)
    assert tcqt._as_kernel(small) is tcqt._as_kernel(small)
    # Objects without weak references (nested lists) go by content.
    assert tcqt._as_kernel(small.tolist()) is tcqt._as_kernel(small.tolist())
    for i in range(tcqt._FOREIGN_KERNEL_LIMIT + 2):
        tcqt._as_kernel((small * (i + 2)).tolist())
    assert len(tcqt._foreign_kernels) <= tcqt._FOREIGN_KERNEL_LIMIT


def test_evicting_a_foreign_kernel_keeps_the_others_device_operators(
        fresh_cache):
    a = scipy.sparse.csr_matrix(tcqt.cqtkernel(8000, 12, 110, 880).kernel)
    b = scipy.sparse.csr_matrix(tcqt.cqtkernel(8000, 12, 220, 880).kernel)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        8000).astype(np.float32))
    for k in (a, b):
        tcqt.cqtspectrogram(x, 8000, 25, k)
        tcqt.cqtspectrogram(x.double(), 8000, 25, k)
    ka, kb = tcqt._as_kernel(a), tcqt._as_kernel(b)

    def entries(k):
        return {key: v for key, v in tcqt._device_kernels.items()
                if key[0] == id(k)}

    before_b = entries(kb)
    assert len(entries(ka)) == 2 and len(before_b) == 2
    tcqt._evict_kernel(("ref", id(a)))
    assert entries(ka) == {}
    after_b = entries(kb)
    assert after_b.keys() == before_b.keys()
    assert all(after_b[key] is before_b[key] for key in after_b)
    # Another upload of b reuses its operator.
    ops = tcqt._device_time_kernel(kb, torch.device("cpu"))
    assert ops is before_b[(id(kb), torch.device("cpu"), torch.float32)][1]


def test_device_operators_fifo_bounded(fresh_cache):
    x = torch.zeros(4000)
    for fmax in range(300, 300 + 10 * (tcqt._DEVICE_KERNEL_LIMIT + 2), 10):
        tcqt.cqtspectrogram(x, 8000, 25,
                            tcqt.cqtkernel(8000, 12, 110, float(fmax)))
    assert len(tcqt._device_kernels) <= tcqt._DEVICE_KERNEL_LIMIT


def test_cqtspectrogram_golden(golden, signal, kernel):
    mine = tcqt.cqtspectrogram(torch.from_numpy(signal), SR, TRES, kernel)
    assert tuple(mine.shape) == golden["cqtspectrogram"].shape
    assert mine.dtype == torch.float64
    np.testing.assert_allclose(_np(mine), golden["cqtspectrogram"],
                               atol=1e-12)


def test_cqtchromagram_golden(golden, signal, kernel):
    mine = tcqt.cqtchromagram(torch.from_numpy(signal), SR, TRES, OR, kernel)
    assert tuple(mine.shape) == golden["cqtchromagram"].shape
    np.testing.assert_allclose(_np(mine), golden["cqtchromagram"],
                               atol=1e-12)


def test_spectrogram_is_a_frames_major_view(signal, kernel):
    mine = tcqt.cqtspectrogram(signal.astype(np.float32), SR, TRES, kernel)
    assert mine.transpose(-1, -2).is_contiguous()


@pytest.mark.parametrize("fn", ["cqtspectrogram", "cqtchromagram"])
def test_f32_matches_zaftpu(signal, kernel, fn):
    x32 = signal.astype(np.float32)
    zk = zcqt.cqtkernel(SR, OR, FMIN, FMAX)
    args = (SR, TRES, OR) if fn == "cqtchromagram" else (SR, TRES)
    ref = np.asarray(getattr(zaftpu, fn)(x32, *args, zk))
    calls = tcqtslab.cqt_magnitudes_plain.calls
    mine = getattr(tcqt, fn)(torch.from_numpy(x32), *args, kernel)
    assert tcqtslab.cqt_magnitudes_plain.calls == calls + 1
    assert mine.dtype == torch.float32 and tuple(mine.shape) == ref.shape
    np.testing.assert_allclose(_np(mine), ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


def test_f32_within_the_golden_tolerance(golden, signal, kernel):
    mine = tcqt.cqtspectrogram(signal.astype(np.float32), SR, TRES, kernel)
    ref = golden["cqtspectrogram"]
    np.testing.assert_allclose(_np(mine), ref, atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batched_matches_rows(signal, kernel, dtype):
    rows = np.stack([np.roll(signal[:22050], 777 * i) for i in range(6)])
    batch = torch.from_numpy(rows.reshape(2, 3, -1).astype(dtype))
    out = tcqt.cqtspectrogram(batch, SR, TRES, kernel)
    chroma = tcqt.cqtchromagram(batch, SR, TRES, OR, kernel)
    assert tuple(out.shape) == (2, 3, 144, 12)
    assert tuple(chroma.shape) == (2, 3, OR, 12)
    for i in range(2):
        for j in range(3):
            one = batch[i, j]
            np.testing.assert_allclose(
                _np(out[i, j]), _np(tcqt.cqtspectrogram(one, SR, TRES,
                                                        kernel)),
                rtol=0, atol=1e-12 if dtype == np.float64 else 1e-7)
            np.testing.assert_allclose(
                _np(chroma[i, j]), _np(tcqt.cqtchromagram(one, SR, TRES, OR,
                                                          kernel)),
                rtol=0, atol=1e-12 if dtype == np.float64 else 1e-6)


@pytest.mark.parametrize("block", ["1024", "7"])
def test_block_boundary_continuity(signal, kernel, block, monkeypatch):
    """Frame counts that are not multiples of the float64 block agree with
    a longer signal's prefix (tests/test_cqt.py:64)."""
    monkeypatch.setenv("ZAFTPU_CQT_BLOCK", block)
    long = np.concatenate([signal, signal])
    short_out = _np(tcqt.cqtspectrogram(signal, SR, TRES, kernel))
    long_out = _np(tcqt.cqtspectrogram(long, SR, TRES, kernel))
    step = round(SR / TRES)
    safe = len(signal) // step - (kernel.fft_length // step + 1)
    np.testing.assert_allclose(long_out[:, :safe], short_out[:, :safe],
                               atol=1e-12)


def test_block_size_does_not_change_the_f64_result(signal, kernel,
                                                    monkeypatch):
    ref = _np(tcqt.cqtspectrogram(signal, SR, TRES, kernel))
    monkeypatch.setenv("ZAFTPU_CQT_BLOCK", "4")
    np.testing.assert_allclose(
        _np(tcqt.cqtspectrogram(signal, SR, TRES, kernel)), ref, rtol=0,
        atol=1e-15)


def test_config_equals_positional(signal, kernel):
    cfg = CqtConfig()
    np.testing.assert_array_equal(
        _np(tcqt.cqtspectrogram(signal, config=cfg)),
        _np(tcqt.cqtspectrogram(signal, SR, TRES, kernel)))
    np.testing.assert_array_equal(
        _np(tcqt.cqtchromagram(signal, config=cfg)),
        _np(tcqt.cqtchromagram(signal, SR, TRES, OR, kernel)))
    # An explicit octave resolution beside config= overrides the fold.
    assert tuple(tcqt.cqtchromagram(signal, octave_resolution=12,
                                    config=cfg).shape) == (12, 25)


def _same_error(call_mine, call_ref):
    with pytest.raises(ValueError) as mine:
        call_mine()
    with pytest.raises(ValueError) as ref:
        call_ref()
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("case", ["both", "missing", "short",
                                  "chroma_missing_or", "chroma_both",
                                  "f16"])
def test_validation_errors_match_zaftpu(case, kernel):
    zk = zcqt.cqtkernel(SR, OR, FMIN, FMAX)
    sig = np.zeros(4000)
    cases = {
        "both": ("cqtspectrogram", (sig, SR, TRES, "K"),
                 {"config": "C"}),
        "missing": ("cqtspectrogram", (sig, SR), {}),
        "short": ("cqtspectrogram", (np.zeros(1000), SR, TRES, "K"), {}),
        "chroma_missing_or": ("cqtchromagram", (sig, SR, TRES, None, "K"),
                              {}),
        "chroma_both": ("cqtchromagram", (sig, SR, None, None, None),
                        {"config": "C"}),
        "f16": ("cqtspectrogram", (sig.astype(np.float16), SR, TRES, "K"),
                {}),
    }
    fn, args, kwargs = cases[case]

    def call(module, kern, cfg):
        a = tuple(kern if isinstance(v, str) else v for v in args)
        kw = {k: cfg for k in kwargs}
        return lambda: getattr(module, fn)(*a, **kw)

    import zaftpu.config as zconfig

    _same_error(call(tcqt, kernel, CqtConfig()),
                call(zaftpu, zk, zconfig.CqtConfig()))


def test_exported_from_the_package(kernel):
    assert zaftpu_torch.cqtkernel is tcqt.cqtkernel
    assert zaftpu_torch.cqtspectrogram is tcqt.cqtspectrogram
    assert zaftpu_torch.cqtchromagram is tcqt.cqtchromagram


def test_cqt_imports_leave_jax_and_zaftpu_out(tmp_path):
    """The CQT, the mirror and full-spectrum levers and their kernel
    modules load no jax, jaxlib or zaftpu module."""
    code = (
        "import os, sys, numpy as np, torch, zaftpu_torch as z\n"
        "import zaftpu_torch.kernels.cqtslab, zaftpu_torch.kernels.mirror\n"
        "x = torch.from_numpy(np.random.default_rng(0).standard_normal("
        "8000))\n"
        "k = z.cqtkernel(8000, 12, 110, 880)\n"
        "z.cqtspectrogram(x, 8000, 25, k); z.cqtchromagram(x.float(), "
        "8000, 25, 12, k)\n"
        "os.environ['ZAFTPU_MIRROR'] = 'pallas'\n"
        "os.environ['ZAFTPU_FULLSPEC'] = '1'\n"
        "w = z.hamming(256); z.istft(z.stft(x, w, 128), w, 128)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zaftpu')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["ZAFTPU_CACHE_DIR"] = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
