"""The CQT's split4 twin (B10's ``_kernel_split4``) and zaftpu's CQT scheme
(``ZAFTPU_CQT_SCHEME``) in zaftpu_torch, against zaftpu.

The twin's plain version against zaftpu's slab kernel in interpret mode
under ``ZAFTPU_PRECISION=split4`` (which hands that kernel the bf16
operator), the presplit operator bit for bit against zaftpu's host split,
the scheme's resolution over tests/test_dispatch.py's environment matrix,
the CPU CQT under every scheme (exact, as zaftpu's CPU backend: the
spectral kernel's plain version, the slab loop under ZAFTPU_FFT=matmul),
and the device operators' cache. The twin's CUDA kernel runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.sparse
import torch

import zaftpu
from zaftpu.pallas import cqtslab as zcqtslab
from zaftpu.transforms import cqt as zcqt
from zaftpu_torch.kernels import cqtfft as tcqtfft
from zaftpu_torch.kernels import cqtslab as tcqtslab
from zaftpu_torch.transforms import cqt as tcqt

# (sr, bins per octave, fmin, fmax, seconds): L 2048 at hop 320 and L 1024
# at hop 320 (neither hop divides L), and L 4096 at hop 882.
GEOMETRIES = [(8000, 12, 110.0, 880.0, 2), (8000, 12, 220.0, 880.0, 1.3),
              (22050, 12, 110.0, 3520.0, 0.7)]


@pytest.fixture
def split4(monkeypatch):
    """ZAFTPU_PRECISION=split4 for both packages; zaftpu reads the dial at
    trace time, so its caches are cleared around the test."""
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path))


def _case(sr, bins, fmin, fmax, seconds, seed, lead=()):
    """zaftpu's kernel, a padded signal as cqtspectrogram pads it (the port
    builds the same kernel bit for bit, tests/test_torch_cqt.py), hop and
    frame count."""
    kern = zcqt.cqtkernel(sr, bins, fmin, fmax)
    step = round(sr / 25)
    n = int(sr * seconds)
    length = kern.fft_length
    x = np.random.default_rng(seed).standard_normal((*lead, n)).astype(
        np.float32)
    pad_front = -(-(length - step) // 2)
    padded = np.pad(x, [(0, 0)] * len(lead) + [(pad_front, length)])
    return kern, padded, step, n // step


def _zaftpu_magnitudes(kern, padded, step, t, key):
    """zaftpu's slab kernel in interpret mode on one padded row."""
    length, f = kern.fft_length, kern.number_frequencies
    zcqtslab.register_kernel(
        key, np.ascontiguousarray(kern.time_kernel.real.T).astype(np.float32),
        np.ascontiguousarray(kern.time_kernel.imag.T).astype(np.float32))
    return np.asarray(zcqtslab.cqt_magnitudes(
        jnp.asarray(padded), key, step, length, t, f, block=16,
        interpret=True))


def _close(mine, ref):
    """The same bf16 x bf16 products and slab order; only the float32 sums
    within a slab product differ (XLA's dot against 256-wide K blocks)."""
    np.testing.assert_allclose(mine, ref, rtol=2e-5,
                               atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("sr,bins,fmin,fmax,seconds", GEOMETRIES)
def test_cqt_magnitudes_split4_matches_zaftpu(sr, bins, fmin, fmax, seconds,
                                              split4):
    kern, padded, step, t = _case(sr, bins, fmin, fmax, seconds, 21)
    ref = _zaftpu_magnitudes(kern, padded, step, t,
                             ("test_torch_cqt_split4", sr, fmin, fmax))
    ops = torch.from_numpy(tcqtslab.time_ops_split4(kern.time_kernel)).to(
        torch.bfloat16)
    calls = tcqtslab.cqt_magnitudes_split4_plain.calls
    mine = tcqtslab.cqt_magnitudes_split4(
        torch.from_numpy(padded), ops, step, kern.fft_length, t,
        kern.number_frequencies)
    assert tcqtslab.cqt_magnitudes_split4_plain.calls == calls + 1
    assert mine.shape == ref.shape and mine.dtype == torch.float32
    _close(mine.numpy(), ref)


def test_cqt_magnitudes_split4_batched_matches_zaftpu(split4):
    """A (2, 2, L) batch through one call against zaftpu row by row; a
    float32 operator is split on the host to the same values."""
    kern, padded, step, t = _case(8000, 12, 110.0, 880.0, 1.1, 22, (2, 2))
    f = kern.number_frequencies
    ops32 = torch.from_numpy(tcqtslab.time_ops(kern.time_kernel))
    mine = tcqtslab.cqt_magnitudes_split4(torch.from_numpy(padded), ops32,
                                          step, kern.fft_length, t, f)
    assert mine.shape == (2, 2, t, f)
    ops = torch.from_numpy(tcqtslab.time_ops_split4(kern.time_kernel)).to(
        torch.bfloat16)
    for i in range(2):
        for j in range(2):
            ref = _zaftpu_magnitudes(kern, padded[i, j], step, t,
                                     ("test_torch_cqt_split4_batch",))
            _close(mine[i, j].numpy(), ref)
            assert torch.equal(mine[i, j], tcqtslab.cqt_magnitudes_split4(
                torch.from_numpy(padded[i, j]), ops, step, kern.fft_length,
                t, f))


@pytest.mark.parametrize("sr,bins,fmin,fmax", [(8000, 12, 110.0, 880.0),
                                               (44100, 24, 55.0, 3520.0)])
def test_presplit_operator_bit_equal_to_zaftpu(sr, bins, fmin, fmax):
    """time_ops_split4 holds zaftpu's _slab_ops_host_split values with the
    slabs put back into rows and the lane-padding rows dropped."""
    kern = zcqt.cqtkernel(sr, bins, fmin, fmax)
    length, f = kern.fft_length, kern.number_frequencies
    step = round(sr / 25)
    n_slabs = -(-length // step)
    key = ("test_torch_cqt_presplit", sr, bins, fmin, fmax)
    zcqtslab.register_kernel(
        key, np.ascontiguousarray(kern.time_kernel.real.T).astype(np.float32),
        np.ascontiguousarray(kern.time_kernel.imag.T).astype(np.float32))
    ref = zcqtslab._slab_ops_host_split(key, n_slabs, step,
                                        zcqtslab._f_pad(f))
    # (slab, component, half, step128, f_pad) -> (half, component, L, F)
    rows = ref[:, :, :, :step, :f].transpose(2, 1, 0, 3, 4).reshape(
        2, 2, n_slabs * step, f)[:, :, :length]
    mine = tcqtslab.time_ops_split4(kern.time_kernel)
    assert mine.shape == (2, 2, length, tcqtslab.padded_cols(f))
    np.testing.assert_array_equal(
        mine[..., :f].view(np.uint32),
        rows.astype(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))
    assert not mine[..., f:].any()
    # Bf16 values: the tensor the kernel takes holds them exactly.
    back = torch.from_numpy(mine).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(back.view(np.uint32), mine.view(np.uint32))


@pytest.mark.parametrize("precision,scheme", [
    (None, None), ("highest", None), ("split4", None), ("HIGHEST", None),
    ("Split4", None), ("high", None), ("default", None), (None, "auto"),
    ("highest", "split4"), (None, "split4"), (None, "exact"),
    ("split4", "exact"), ("highest", "exact"), ("highest", "other")])
def test_scheme_resolution_matches_zaftpu(precision, scheme, monkeypatch):
    """tests/test_dispatch.py:219-245's matrix and its neighbours: an unset
    dial selects split4, an explicit one other than split4 does not, and
    ZAFTPU_CQT_SCHEME forces split4 or follows the dial."""
    for name, value in (("ZAFTPU_PRECISION", precision),
                        ("ZAFTPU_CQT_SCHEME", scheme)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert tcqt._slab_scheme_split4() is zcqt._slab_scheme_split4()


@pytest.mark.parametrize("fft", ["auto", "matmul"])
@pytest.mark.parametrize("scheme", [None, "split4", "exact"])
@pytest.mark.parametrize("precision", [None, "highest", "split4", "high"])
def test_cpu_cqt_exact_under_every_scheme(scheme, precision, fft, cache_dir,
                                          monkeypatch):
    """On the CPU the CQT runs an exact path whatever the scheme and the dial
    say, bit-equal to the unset default, and matches zaftpu's CPU CQT under
    the same environment: the spectral kernel's plain version at L 2048,
    the exact slab loop under ZAFTPU_FFT=matmul; the twin's plain version
    never runs."""
    kern = tcqt.cqtkernel(8000, 12, 110.0, 880.0)
    zk = zcqt.cqtkernel(8000, 12, 110.0, 880.0)
    x32 = np.random.default_rng(23).standard_normal(16000).astype(np.float32)
    x = torch.from_numpy(x32)
    monkeypatch.delenv("ZAFTPU_PRECISION", raising=False)
    monkeypatch.delenv("ZAFTPU_CQT_SCHEME", raising=False)
    monkeypatch.setenv("ZAFTPU_FFT", fft)
    ref_spec = tcqt.cqtspectrogram(x, 8000, 25, kern)
    ref_chroma = tcqt.cqtchromagram(x, 8000, 25, 12, kern)
    if precision is not None:
        monkeypatch.setenv("ZAFTPU_PRECISION", precision)
    if scheme is not None:
        monkeypatch.setenv("ZAFTPU_CQT_SCHEME", scheme)
    jax.clear_caches()
    calls = (tcqtfft.cqt_magnitudes_fft_plain.calls,
             tcqtslab.cqt_magnitudes_plain.calls,
             tcqtslab.cqt_magnitudes_split4_plain.calls)
    spec = tcqt.cqtspectrogram(x, 8000, 25, kern)
    chroma = tcqt.cqtchromagram(x, 8000, 25, 12, kern)
    moved = (2, 0) if fft == "auto" else (0, 2)
    assert (tcqtfft.cqt_magnitudes_fft_plain.calls,
            tcqtslab.cqt_magnitudes_plain.calls,
            tcqtslab.cqt_magnitudes_split4_plain.calls) == (
                calls[0] + moved[0], calls[1] + moved[1], calls[2])
    assert torch.equal(spec, ref_spec) and torch.equal(chroma, ref_chroma)
    for mine, ref in ((spec, zaftpu.cqtspectrogram(x32, 8000, 25, zk)),
                      (chroma, zaftpu.cqtchromagram(x32, 8000, 25, 12, zk))):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                   atol=2e-6 * np.abs(ref).max())
    jax.clear_caches()


def test_presplit_operator_has_its_own_device_entry(cache_dir):
    """The float32 operator and its presplit are two entries of one kernel
    (keyed by dtype); evicting a foreign kernel drops both."""
    dense = tcqt.cqtkernel(8000, 12, 110.0, 880.0).kernel
    sparse = scipy.sparse.csr_matrix(dense)
    kern = tcqt._as_kernel(sparse)
    cpu = torch.device("cpu")
    f32 = tcqt._device_time_kernel(kern, cpu)
    bf16 = tcqt._device_time_kernel(kern, cpu, split4=True)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert bf16.shape == (2, *f32.shape)
    assert tcqt._device_time_kernel(kern, cpu, split4=True) is bf16
    assert tcqt._device_time_kernel(kern, cpu) is f32
    np.testing.assert_array_equal(
        bf16.float().numpy(), tcqtslab.time_ops_split4(kern.time_kernel))
    keys = {k for k in tcqt._device_kernels if k[0] == id(kern)}
    assert keys == {(id(kern), cpu, torch.float32),
                    (id(kern), cpu, torch.bfloat16)}
    tcqt._evict_kernel(("ref", id(sparse)))
    assert not [k for k in tcqt._device_kernels if k[0] == id(kern)]
