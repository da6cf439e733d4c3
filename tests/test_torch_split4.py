"""The split4 precision dial in zaftpu_torch against zaftpu's.

``ZAFTPU_PRECISION`` parsing and routing (``core/policy.py``), the host and
torch hi/lo splits bit for bit against ``zaftpu``'s, the plain versions of
the split4 twins (B1, B2, B3, B4, B7, B12) and of B12's exact form against
``zaftpu``'s Pallas kernels in interpret mode with the same dial, the
STFT and MDCT slices under split4 against ``zaftpu`` under split4 with
``ZAFTPU_FFT=matmul``, the levers under the dial, the magnitude and mel
front ends' gate, and the device rule of the public functions (a non-tensor
input goes to the card; without one it raises).

The twins' CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against these plain versions there).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import zaftpu
import zaftpu_torch
from conftest import snr_db
from zaftpu.core import policy as zpolicy
from zaftpu.core.windows import hamming, vorbis
from zaftpu.pallas import fused as zfused
from zaftpu.pallas import melfused as zmelfused
from zaftpu.pallas import synth as zsynth
from zaftpu.transforms import mdct as zmdct
from zaftpu_torch.core import fft as tfft
from zaftpu_torch.core import policy
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import cqtslab as tcqtslab
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import melfused as tmelfused
from zaftpu_torch.kernels import rfft as trfft
from zaftpu_torch.kernels import synth as tsynth

SR, WL, STEP = 44100, 2048, 1024
# WL, hop, T for the kernel comparisons: zaftpu's fused kernels need
# hop % 128 == 0 and hop | WL; T = 37 and 5 are not multiples of 8.
SHAPES = [(512, 256, 37), (256, 128, 5)]


@pytest.fixture
def split4(monkeypatch):
    """ZAFTPU_PRECISION=split4 for both packages; zaftpu reads the dial at
    trace time, so its caches are cleared around the test."""
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def x32():
    return np.random.default_rng(0).standard_normal(SR * 2).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy()


def _signal(wl, step, t, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(t * step + wl - step).astype(np.float32)


def _gemm_close(mine, ref):
    """Both packages form the same bf16 x bf16 products; only the float32
    summation order differs (XLA's dot against 256-wide K blocks), which
    moves results by about 1e-7 of max: gate at 2e-6 of max."""
    np.testing.assert_allclose(mine, ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


# ---- The dial -------------------------------------------------------------

@pytest.mark.parametrize("value,split", [
    (None, False), ("highest", False), ("HIGHEST", False), ("high", False),
    ("default", False), ("split4", True), ("Split4", True)])
def test_dial_parsing(value, split, monkeypatch):
    if value is None:
        monkeypatch.delenv("ZAFTPU_PRECISION", raising=False)
    else:
        monkeypatch.setenv("ZAFTPU_PRECISION", value)
    assert policy.split4_enabled() is split
    assert policy.split4_enabled() == zpolicy.split4_enabled()
    assert policy.precision() == (value or "highest").lower()


@pytest.mark.parametrize("value", ["bf16", "split3", ""])
def test_bad_dial_raises_zaftpus_error(value, monkeypatch):
    monkeypatch.setenv("ZAFTPU_PRECISION", value)
    with pytest.raises(ValueError) as mine:
        policy.precision()
    with pytest.raises(ValueError) as ref:
        zpolicy.matmul_precision()
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError):
        policy.split4_enabled()


@pytest.mark.parametrize("value", ["high", "default"])
def test_tpu_pass_count_dials_run_exact_on_cpu_and_refuse_cuda(
        value, monkeypatch):
    """``high`` and ``default`` are TPU matrix-unit pass counts: on the CPU
    the port runs the exact path (bit-equal to ``highest``); the CUDA path
    refuses them."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        8192).astype(np.float32))
    win = hamming(512)
    ref = zaftpu_torch.stft(x, win, 256)
    monkeypatch.setenv("ZAFTPU_PRECISION", value)
    assert torch.equal(zaftpu_torch.stft(x, win, 256), ref)
    with pytest.raises(NotImplementedError, match=value):
        policy.check_cuda_dial()


@pytest.mark.parametrize("case,passes", [
    ("wide", 4), ("narrow", 1), ("bandwidth_bound", 1), ("float64", 1),
    ("exact_dial", 1)])
def test_real_matmul_routing(case, passes, monkeypatch):
    """zaftpu's routing (tests/test_bf16.py:219-243): four exact GEMMs of
    the halves for a wide float32 operator under split4; one exact GEMM for
    an operator under 256 columns, a bandwidth-bound GEMM, float64 or the
    exact dial."""
    monkeypatch.setenv("ZAFTPU_PRECISION",
                       "highest" if case == "exact_dial" else "split4")
    calls = []
    exact = policy.exact_matmul

    def counted(a, b):
        calls.append(a.shape)
        return exact(a, b)

    monkeypatch.setattr(policy, "exact_matmul", counted)
    dtype = torch.float64 if case == "float64" else torch.float32
    a = torch.zeros((8, 1764), dtype=dtype)
    b = torch.zeros((1764, 144 if case == "narrow" else 1024), dtype=dtype)
    out = policy.real_matmul(a, b, bandwidth_bound=case == "bandwidth_bound")
    assert len(calls) == passes
    assert out.shape == (8, b.shape[1]) and out.dtype == dtype


def test_split4_matmul_matches_zaftpu():
    """The same split and the same four products: only the summation order
    differs, 1e-6 of max."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((64, 700)).astype(np.float32)
    b = rng.standard_normal((700, 300)).astype(np.float32)
    ref = np.asarray(zpolicy._split4_matmul(jnp.asarray(a), jnp.asarray(b)))
    mine = _np(policy.split4_matmul(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(mine, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert snr_db(exact.ravel(), mine.ravel()) > 100.0


def _awkward_values() -> np.ndarray:
    """Ties at the bf16 rounding point (both parities of the kept last
    bit), subnormals, large values, signed zeros and random values."""
    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x3F80FFFF,
                     0x3F807FFF, 0x00008000, 0x00018000, 0x7F7F7FFF,
                     0x00000001, 0x80000001, 0x007FFFFF, 0x00800000],
                    np.uint32).view(np.float32)
    special = np.array([0.0, -0.0, 1e-40, -3e-39, 1.4e-45, 3.3e38, -1e38,
                        65504.0, 1.0, -1.0 / 3.0], np.float32)
    rand = np.random.default_rng(3).standard_normal(997).astype(np.float32)
    return np.concatenate([ties, special, rand * 1e3, rand * 1e-30])


def test_host_split_bit_equal_to_zaftpu():
    m = _awkward_values()
    hi, lo = policy.bf16_split_host(m)
    zhi, zlo = zfused._bf16_split_host(m)
    np.testing.assert_array_equal(hi.view(np.uint32), zhi.view(np.uint32))
    zlo16 = zlo.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(lo.view(np.uint32), zlo16.view(np.uint32))
    # Both halves are bf16 values, so they turn into bf16 tensors exactly.
    for half in (hi, lo):
        back = torch.from_numpy(half).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(back.view(np.uint32),
                                      half.view(np.uint32))


def test_torch_split_bit_equal_to_zaftpu_and_host():
    """The torch split equals the host split on every value, subnormals
    included, and zaftpu's XLA split wherever XLA's CPU backend, which
    flushes subnormal operands to zero, keeps the value: inputs and
    differences that are zero or normal."""
    m = _awkward_values()
    hi, lo = policy.bf16_split(torch.from_numpy(m))
    zhi, zlo = zpolicy._bf16_split(jnp.asarray(m))
    tiny = np.finfo(np.float32).tiny
    diff = m - hi.float().numpy()
    kept = ((np.abs(m) >= tiny) & ((diff == 0) | (np.abs(diff) >= tiny)))
    assert kept.sum() > 1000
    for mine, ref in ((hi, zhi), (lo, zlo)):
        np.testing.assert_array_equal(
            mine.float().numpy()[kept].view(np.uint32),
            np.asarray(ref).astype(np.float32)[kept].view(np.uint32))
    hhi, hlo = policy.bf16_split_host(m)
    np.testing.assert_array_equal(hi.float().numpy().view(np.uint32),
                                  hhi.view(np.uint32))
    np.testing.assert_array_equal(lo.float().numpy().view(np.uint32),
                                  hlo.view(np.uint32))


@pytest.mark.parametrize("n", [512, 2048])
def test_presplit_operators_bit_equal_to_zaftpu(n):
    """The presplit rDFT, inverse-rDFT and inverse-MDCT stacks the kernels
    take equal zaftpu's host presplits on the valid rows and columns."""
    f = n // 2 + 1
    mine = tfft.device_operator(tfused._rdft_ops, (n, "float32"),
                                torch.device("cpu"), torch.bfloat16,
                                presplit=True)
    ref = zfused._split_ops_of(zfused._rdft_ops_padded, n)  # (C, 2, N, Fp)
    np.testing.assert_array_equal(
        mine.float().numpy()[:, :, :, :f],
        ref.astype(np.float32).transpose(1, 0, 2, 3)[:, :, :, :f])
    mine = tsynth.istft_ops_split4(n, 0.5, "cpu")  # (2, 2 * KP, N)
    ref = zsynth._split_ops_of(zsynth._istft_ops_padded, n, 0.5)
    kp = tsynth.padded_rows(n)
    for c in range(2):
        np.testing.assert_array_equal(
            mine.float().numpy()[:, c * kp:c * kp + f],
            ref.astype(np.float32)[c, :, :f])
    wb = vorbis(n).tobytes()
    mine = tsynth.imdct_ops_split4(n // 2, wb, "cpu")
    ref = zsynth._split_ops_of(zsynth._imdct_ops_padded, n // 2, wb)
    np.testing.assert_array_equal(mine.float().numpy()[:, :n // 2],
                                  ref.astype(np.float32)[0])


# ---- Each twin's plain version against zaftpu's kernel ---------------------

@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_frames_rfft_split4_matches_zaftpu(wl, step, t, split4):
    padded = _signal(wl, step, t, 4)
    win = hamming(wl).astype(np.float32)
    ref = np.asarray(zfused.frames_rfft(
        jnp.asarray(padded), jnp.asarray(win), wl, step, t, interpret=True))
    calls = tfused.frames_rfft_split4_plain.calls
    mine = tfused.frames_rfft(torch.from_numpy(padded), torch.from_numpy(win),
                              wl, step, t)
    assert tfused.frames_rfft_split4_plain.calls == calls + 1
    assert mine.shape == ref.shape and mine.dtype == torch.complex64
    _gemm_close(_np(mine).real, ref.real)
    _gemm_close(_np(mine).imag, ref.imag)


@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_frames_op_split4_matches_zaftpu(wl, step, t, split4):
    padded = _signal(wl, step, t, 5)
    win = vorbis(wl).astype(np.float32)
    f = wl // 2
    ref = np.asarray(zfused.frames_op(
        jnp.asarray(padded), jnp.asarray(win),
        zmdct._direct_forward_ops_padded, f, wl, step, t, interpret=True))
    ops = tfft.operators_from_numpy(zmdct._direct_forward_ops_padded(wl), wl,
                                    "mdct")
    calls = tfused.frames_op_split4_plain.calls
    mine = tfused.frames_op(torch.from_numpy(padded), torch.from_numpy(win),
                            ops, f, wl, step, t)
    assert tfused.frames_op_split4_plain.calls == calls + 1
    assert mine.shape == ref.shape and mine.dtype == torch.float32
    _gemm_close(_np(mine), ref)


@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_frames_rfft_full_split4_matches_zaftpu(wl, step, t, split4):
    padded = _signal(wl, step, t, 6)
    win = hamming(wl).astype(np.float32)
    re, im = zfused.frames_rfft_full(jnp.asarray(padded), jnp.asarray(win),
                                     wl, step, t, interpret=True)
    calls = tfused.frames_rfft_full_split4_plain.calls
    mine = tfused.frames_rfft_full(torch.from_numpy(padded),
                                   torch.from_numpy(win), wl, step, t)
    assert tfused.frames_rfft_full_split4_plain.calls == calls + 1
    assert tuple(mine.shape) == (t, wl)
    _gemm_close(_np(mine).real, np.asarray(re))
    _gemm_close(_np(mine).imag, np.asarray(im))
    half = tfused.frames_rfft(torch.from_numpy(padded), torch.from_numpy(win),
                              wl, step, t)
    assert torch.equal(mine, tfft.conjugate_mirror(half, wl))


@pytest.mark.parametrize("dial", ["highest", "split4"])
@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_frames_matmul2_matches_zaftpu(wl, step, t, dial, monkeypatch):
    """B12 under each dial: zaftpu's two-output kernel's planes, and the
    port's bit-equal to its one-output half spectrum. On the exact dial
    these power-of-two windows take the FFT kernel's planes store."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    jax.clear_caches()
    padded = _signal(wl, step, t, 7)
    win = hamming(wl).astype(np.float32)
    f = wl // 2 + 1
    ops, precision = zfused._dispatch_ops(zfused._rdft_ops_padded, wl)
    re, im = zfused.frames_matmul2(jnp.asarray(padded), jnp.asarray(win), ops,
                                   wl, step, t, precision, interpret=True)
    assert trfft.applies(wl)
    plain = (tfused.frames_matmul2_split4_plain if dial == "split4"
             else trfft.frames_matmul2_fft_plain)
    calls = plain.calls
    mre, mim = tfused.frames_matmul2(torch.from_numpy(padded),
                                     torch.from_numpy(win), wl, step, t)
    assert plain.calls == calls + 1
    assert mre.shape == mim.shape == (t, f) and mre.dtype == torch.float32
    _gemm_close(_np(mre), np.asarray(re)[:, :f])
    _gemm_close(_np(mim), np.asarray(im)[:, :f])
    half = tfused.frames_rfft(torch.from_numpy(padded), torch.from_numpy(win),
                              wl, step, t)
    assert torch.equal(torch.complex(mre, mim), half)
    jax.clear_caches()


@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_istft_ola_split4_matches_zaftpu(wl, step, t, split4, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    rng = np.random.default_rng(8)
    h_re, h_im = rng.standard_normal((2, t, wl // 2 + 1)).astype(np.float32)
    scale = 0.7310586
    ref = np.asarray(zsynth.istft_ola(jnp.asarray(h_re), jnp.asarray(h_im),
                                      wl, step, scale, interpret=True))
    calls = tsynth.istft_ola_split4_plain.calls
    mine = tsynth.istft_ola(torch.from_numpy(h_re), torch.from_numpy(h_im),
                            wl, step, scale)
    assert tsynth.istft_ola_split4_plain.calls == calls + 1
    assert mine.shape == ref.shape and mine.dtype == torch.float32
    _gemm_close(_np(mine), ref)


@pytest.mark.parametrize("f,t", [(256, 37), (100, 5)])
def test_imdct_ola_split4_matches_zaftpu(f, t, split4):
    rng = np.random.default_rng(9)
    coeffs = rng.standard_normal((t, f)).astype(np.float32)
    wb = vorbis(2 * f).tobytes()
    ref = np.asarray(zsynth.imdct_ola(jnp.asarray(coeffs), f, wb,
                                      interpret=True))
    calls = tsynth.imdct_ola_split4_plain.calls
    mine = tsynth.imdct_ola(torch.from_numpy(coeffs), f, wb)
    assert tsynth.imdct_ola_split4_plain.calls == calls + 1
    assert mine.shape == ref.shape and mine.dtype == torch.float32
    _gemm_close(_np(mine), ref)


def test_twins_take_zaftpus_presplit_operators(split4):
    """A twin given the presplit stack or the float32 operator it is split
    from computes the same values."""
    wl, step, t = 512, 256, 9
    padded = torch.from_numpy(_signal(wl, step, t, 10))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    ops = tfused.rdft_ops(wl, torch.float32, "cpu")
    a = tfused.frames_rfft_split4(padded, win, wl, step, t, ops)
    b = tfused.frames_rfft_split4(padded, win, wl, step, t,
                                  policy.presplit(ops))
    c = tfused.frames_rfft_split4(padded, win, wl, step, t)
    assert torch.equal(a, b) and torch.equal(a, c)


# ---- The slices ------------------------------------------------------------

def test_stft_istft_split4_match_zaftpu(x32, split4, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    win = hamming(WL).astype(np.float32)
    ref = np.asarray(zaftpu.stft(x32, win, STEP))
    mine = zaftpu_torch.stft(torch.from_numpy(x32), win, STEP)
    assert mine.dtype == torch.complex64 and tuple(mine.shape) == ref.shape
    _gemm_close(_np(mine).real, ref.real)
    _gemm_close(_np(mine).imag, ref.imag)
    rec = _np(zaftpu_torch.istft(mine, win, STEP))
    ref_rec = np.asarray(zaftpu.istft(ref, win, STEP))
    _gemm_close(rec, ref_rec)
    assert 100.0 < snr_db(x32, rec) < 125.0  # split4, not the exact dial
    assert 100.0 < snr_db(x32, ref_rec) < 125.0


def test_mdct_imdct_split4_match_zaftpu(x32, split4, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    win = vorbis(WL).astype(np.float32)
    ref = np.asarray(zaftpu.mdct(x32, win))
    mine = zaftpu_torch.mdct(torch.from_numpy(x32), win)
    assert mine.dtype == torch.float32 and tuple(mine.shape) == ref.shape
    _gemm_close(_np(mine), ref)
    rec = _np(zaftpu_torch.imdct(mine, win))
    _gemm_close(rec, np.asarray(zaftpu.imdct(ref, win)))
    assert 100.0 < snr_db(x32, rec) < 125.0


@pytest.mark.parametrize("fused,synth", [("auto", "auto"), ("0", "0")])
def test_split4_round_trips_move_and_exact_stays_above(x32, fused, synth,
                                                       monkeypatch):
    """The dial takes effect on both dispatches: the round trips read in
    (100, 125) dB under split4 and above 125 dB on the exact dial."""
    monkeypatch.setenv("ZAFTPU_FUSED", fused)
    monkeypatch.setenv("ZAFTPU_SYNTH", synth)
    x = torch.from_numpy(x32)
    hw, vw = hamming(WL), vorbis(WL)
    for dial, lo, hi in (("highest", 125.0, np.inf), ("split4", 100.0, 125.0)):
        monkeypatch.setenv("ZAFTPU_PRECISION", dial)
        rec = zaftpu_torch.istft(zaftpu_torch.stft(x, hw, STEP), hw, STEP)
        rec2 = zaftpu_torch.imdct(zaftpu_torch.mdct(x, vw), vw)
        assert lo < snr_db(x32, _np(rec)) < hi, dial
        assert lo < snr_db(x32, _np(rec2)) < hi, dial


def test_float64_is_unchanged_by_the_dial(signal, monkeypatch):
    x = torch.from_numpy(signal)
    hw, vw = hamming(WL), vorbis(WL)

    def outputs():
        spec = zaftpu_torch.stft(x, hw, STEP)
        coeffs = zaftpu_torch.mdct(x, vw)
        return (spec, zaftpu_torch.istft(spec, hw, STEP), coeffs,
                zaftpu_torch.imdct(coeffs, vw),
                zaftpu_torch.spectrogram(x, hw, STEP))

    ref = outputs()
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    for got, want in zip(outputs(), ref):
        assert got.dtype in (torch.float64, torch.complex128)
        assert torch.equal(got, want)


@pytest.mark.parametrize("lever", ["ZAFTPU_FUSED2", "ZAFTPU_FULLSPEC"])
@pytest.mark.parametrize("dial", ["highest", "split4"])
def test_levers_equal_the_default_under_each_dial(x32, lever, dial,
                                                  monkeypatch):
    """ZAFTPU_FUSED2=1 stores the default analysis's sums under both dials,
    and ZAFTPU_FULLSPEC=1 under split4: stft and the round trip are
    bit-equal to the default. On the exact dial the full-spectrum kernel
    stays a GEMM while the default at WL 2048 is the FFT kernel: there the
    lever's spectrum sits within float32 rounding of the default's and of
    the float64 oracle."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    x = torch.from_numpy(x32)
    win = hamming(WL)
    ref = zaftpu_torch.stft(x, win, STEP)
    monkeypatch.setenv(lever, "1")
    counted = {"ZAFTPU_FUSED2": (tfused.frames_matmul2_split4_plain
                                 if dial == "split4"
                                 else trfft.frames_matmul2_fft_plain),
               "ZAFTPU_FULLSPEC": (tfused.frames_rfft_full_split4_plain
                                   if dial == "split4"
                                   else tfused.frames_rfft_full_plain)}[lever]
    calls = counted.calls
    spec = zaftpu_torch.stft(x, win, STEP)
    assert counted.calls == calls + 1
    rec = zaftpu_torch.istft(spec, win, STEP)
    ref_rec = zaftpu_torch.istft(ref, win, STEP)
    if lever == "ZAFTPU_FULLSPEC" and dial == "highest":
        oracle = _np(zaftpu_torch.stft(x.double(), win, STEP))
        for got in (spec, ref):
            _gemm_close(_np(got).real, oracle.real)
            _gemm_close(_np(got).imag, oracle.imag)
        _gemm_close(_np(rec), _np(ref_rec))
        return
    assert torch.equal(spec, ref)
    assert torch.equal(rec, ref_rec)


def test_fused2_lever_is_off_unless_one(monkeypatch):
    for value, on in ((None, False), ("0", False), ("auto", False),
                      ("1", True)):
        if value is None:
            monkeypatch.delenv("ZAFTPU_FUSED2", raising=False)
        else:
            monkeypatch.setenv("ZAFTPU_FUSED2", value)
        assert tfused.fused2_enabled() is on
        assert zfused.fused2_enabled() is on


# ---- The magnitude and mel front ends under split4 -------------------------

@pytest.mark.parametrize("melfuse,wanted", [(None, False), ("auto", False),
                                            ("0", False), ("1", True)])
def test_melfuse_gate_under_split4(melfuse, wanted, monkeypatch):
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    if melfuse is None:
        monkeypatch.delenv("ZAFTPU_MELFUSE", raising=False)
    else:
        monkeypatch.setenv("ZAFTPU_MELFUSE", melfuse)
    for wl in (2048, 1764):
        assert tmelfused.kernel_wanted(torch.float32, wl) is wanted
    # float64 never lowers, so the dial does not move it: the lever and the
    # FFT shape rule decide, as on the exact dial.
    assert tmelfused.kernel_wanted(torch.float64, 1764) is (melfuse != "0")
    assert tmelfused.kernel_wanted(torch.float64, 2048) is (melfuse == "1")


def test_front_ends_take_the_split4_half_spectrum(x32, split4, monkeypatch):
    """spectrogram, melspectrogram and mfcc under split4 run B1's twin
    (once each) and agree with zaftpu's split4 outputs (its GEMM engine,
    where the dial applies)."""
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    x = torch.from_numpy(x32)
    win = hamming(WL).astype(np.float32)
    fb = zaftpu.melfilterbank(SR, WL, 40)
    calls = (tfused.frames_rfft_split4_plain.calls,
             tmelfused.spec_rows_plain.calls, tmelfused.mel_rows_plain.calls)
    outs = (zaftpu_torch.spectrogram(x, win, STEP),
            zaftpu_torch.melspectrogram(x, win, STEP, fb),
            zaftpu_torch.mfcc(x, win, STEP, fb, 20))
    assert (tfused.frames_rfft_split4_plain.calls,
            tmelfused.spec_rows_plain.calls,
            tmelfused.mel_rows_plain.calls) == (calls[0] + 3, *calls[1:])
    refs = (zaftpu.spectrogram(x32, win, STEP),
            zaftpu.melspectrogram(x32, win, STEP, fb),
            zaftpu.mfcc(x32, win, STEP, fb, 20))
    for mine, ref in zip(outs[:2], refs[:2]):
        _gemm_close(_np(mine), np.asarray(ref))
    np.testing.assert_allclose(_np(outs[2]), np.asarray(refs[2]), rtol=0,
                               atol=5e-3)  # the log domain (test_mel.py:70)


@pytest.mark.parametrize("power", [False, True])
def test_forced_melfuse_under_split4(power, split4):
    """ZAFTPU_MELFUSE=1 under split4: mel_rows takes its split4 twin (as
    zaftpu's _kernel_split4 does, compared in interpret mode), spec_rows
    stays exact (it has no twin, in zaftpu either)."""
    wl, step, t = 512, 128, 21
    padded = _signal(wl, step, t, 11)
    win = hamming(wl).astype(np.float32)
    fb = zaftpu.melfilterbank(8000, wl, 20).astype(np.float32)
    fbt = np.ascontiguousarray(fb.T)
    ref = np.asarray(zmelfused.mel_rows(
        jnp.asarray(padded), jnp.asarray(win), jnp.asarray(fbt), wl, step, t,
        power, interpret=True))
    calls = tmelfused.mel_rows_split4_plain.calls
    mine = tmelfused.mel_rows(torch.from_numpy(padded), torch.from_numpy(win),
                              torch.from_numpy(fbt), wl, step, t, power)
    assert tmelfused.mel_rows_split4_plain.calls == calls + 1
    _gemm_close(_np(mine), ref)
    spec = tmelfused.spec_rows(torch.from_numpy(padded),
                               torch.from_numpy(win), wl, step, t)
    ref_spec = np.asarray(zmelfused.spec_rows(
        jnp.asarray(padded), jnp.asarray(win), wl, step, t, interpret=True))
    _gemm_close(_np(spec), ref_spec)


MEL_SHAPES = [(512, 128, 21, 8000, 20), (256, 128, 5, 16000, 7),
              (512, 256, 37, 22050, 40)]


@pytest.mark.parametrize("power", [False, True])
@pytest.mark.parametrize("wl,step,t,sr,mels", MEL_SHAPES)
def test_mel_rows_split4_matches_zaftpu(wl, step, t, sr, mels, power,
                                        split4):
    """B9's twin (its plain version, called by name) against zaftpu's
    _kernel_split4 in interpret mode."""
    padded = _signal(wl, step, t, 15)
    win = hamming(wl).astype(np.float32)
    fbt = np.ascontiguousarray(
        zaftpu.melfilterbank(sr, wl, mels).T.astype(np.float32))
    ref = np.asarray(zmelfused.mel_rows(
        jnp.asarray(padded), jnp.asarray(win), jnp.asarray(fbt), wl, step, t,
        power, interpret=True))
    calls = tmelfused.mel_rows_split4_plain.calls
    mine = tmelfused.mel_rows_split4(torch.from_numpy(padded),
                                     torch.from_numpy(win),
                                     torch.from_numpy(fbt), wl, step, t,
                                     power)
    assert tmelfused.mel_rows_split4_plain.calls == calls + 1
    assert mine.shape == ref.shape == (t, mels)
    _gemm_close(_np(mine), ref)


def test_mel_rows_split4_batched_and_operators(split4):
    """A (2, 3, L) batch equals its rows; the presplit operator, its
    float32 source and the cached default give the same values."""
    wl, step, t = 512, 128, 9
    rng = np.random.default_rng(16)
    padded = torch.from_numpy(rng.standard_normal(
        (2, 3, t * step + wl - step)).astype(np.float32))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    fbt = torch.from_numpy(rng.random((wl // 2, 6)).astype(np.float32))
    out = tmelfused.mel_rows_split4(padded, win, fbt, wl, step, t, True)
    ops = tmelfused.spec_ops(wl, torch.float32, "cpu")
    for i in range(2):
        for j in range(3):
            one = tmelfused.mel_rows_split4(padded[i, j], win, fbt, wl, step,
                                            t, True)
            torch.testing.assert_close(out[i, j], one)
    a = tmelfused.mel_rows_split4(padded[0, 0], win, fbt, wl, step, t, False,
                                  ops)
    b = tmelfused.mel_rows_split4(padded[0, 0], win, fbt, wl, step, t, False,
                                  policy.presplit(ops))
    c = tmelfused.mel_rows_split4(padded[0, 0], win, fbt, wl, step, t, False)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_mel_front_ends_under_forced_melfuse_match_zaftpu(x32, split4,
                                                          monkeypatch):
    """ZAFTPU_MELFUSE=1 under split4: melspectrogram and mfcc run B9's twin
    (its plain version here), spectrogram the exact spec_rows, as zaftpu's
    front ends do through their kernels (interpret mode)."""
    import functools

    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    monkeypatch.setenv("ZAFTPU_MELFUSE", "1")
    monkeypatch.setenv("ZAFTPU_PALLAS", "1")
    monkeypatch.setattr(zmelfused, "mel_rows",
                        functools.partial(zmelfused.mel_rows, interpret=True))
    monkeypatch.setattr(zmelfused, "spec_rows",
                        functools.partial(zmelfused.spec_rows,
                                          interpret=True))
    x = torch.from_numpy(x32)
    win = hamming(WL).astype(np.float32)
    fb = zaftpu.melfilterbank(SR, WL, 40)
    calls = (tmelfused.spec_rows_plain.calls,
             tmelfused.mel_rows_split4_plain.calls,
             tmelfused.mel_rows_plain.calls,
             tfused.frames_rfft_split4_plain.calls)
    outs = (zaftpu_torch.spectrogram(x, win, STEP),
            zaftpu_torch.melspectrogram(x, win, STEP, fb),
            zaftpu_torch.mfcc(x, win, STEP, fb, 20))
    assert (tmelfused.spec_rows_plain.calls,
            tmelfused.mel_rows_split4_plain.calls,
            tmelfused.mel_rows_plain.calls,
            tfused.frames_rfft_split4_plain.calls) == (
                calls[0] + 1, calls[1] + 2, calls[2], calls[3])
    refs = (zaftpu.spectrogram(x32, win, STEP),
            zaftpu.melspectrogram(x32, win, STEP, fb),
            zaftpu.mfcc(x32, win, STEP, fb, 20))
    for mine, ref in zip(outs[:2], refs[:2]):
        _gemm_close(_np(mine), np.asarray(ref))
    np.testing.assert_allclose(_np(outs[2]), np.asarray(refs[2]), rtol=0,
                               atol=5e-3)  # the log domain (test_mel.py:70)


# ---- The new CUDA wrappers refuse before launching -------------------------

def _bad_split4_launch(case):
    wl, step, t = 256, 128, 9
    f = wl // 2 + 1
    padded = torch.zeros(t * step + wl - step)
    win = torch.zeros(wl)
    h = torch.zeros(t, f)
    ops = tfused.rdft_ops(wl, torch.float32, "cpu")
    sops = policy.presplit(ops)
    fbt = torch.zeros(wl // 2, 20)
    mel_ops = tmelfused.split4_spec_ops(None, wl, "cpu")
    length, cf = 2048, 36
    sig = torch.zeros((t - 1) * 320 + length)
    cops = torch.zeros(2, 2, length, 64, dtype=torch.bfloat16)
    calls = {
        "rfft_f64": lambda: tfused._frames_rfft_cuda(
            padded.double(), win, wl, step, t, split4=True),
        "rfft_ops": lambda: tfused._frames_rfft_cuda(
            padded, win, wl, step, t, ops=sops[:, :, :, :-64], split4=True),
        "full_short": lambda: tfused._frames_rfft_cuda(
            padded[:-1], win, wl, step, t, full=True, split4=True),
        "op_ops": lambda: tfused._frames_op_cuda(
            padded, win, sops[:, :, :, :64], wl // 2, wl, step, t,
            split4=True),
        "planes_ops": lambda: tfused._launch(
            "frames_matmul2", "planes", False, padded, win, wl, step, t,
            sops, f),
        "planes_s4_ops": lambda: tfused._launch(
            "frames_matmul2_split4", "planes", True, padded, win, wl, step,
            t, ops, f),
        "synth_f64": lambda: tsynth._istft_ola_cuda(
            h.double(), h.double(), wl, step, 1.0, split4=True),
        "synth_width": lambda: tsynth._istft_ola_cuda(
            h[:, :-1], h[:, :-1], wl, step, 1.0, split4=True),
        "synth_ops": lambda: tsynth._gemm_ola(
            torch.zeros(1, t, 2 * tsynth.padded_rows(wl)),
            tsynth.istft_ops(wl, 1.0, torch.float32, "cpu"), wl, step,
            "istft_ola_split4", split4=True),
        "imdct_f64": lambda: tsynth._imdct_ola_cuda(
            torch.zeros(t, wl // 2, dtype=torch.float64), wl // 2,
            vorbis(wl).tobytes(), split4=True),
        "mel_f64": lambda: tmelfused._mel_rows_cuda(
            padded.double(), win, fbt, wl, step, t, False, split4=True),
        "mel_fbank_f64": lambda: tmelfused._mel_rows_cuda(
            padded, win, fbt.double(), wl, step, t, False, split4=True),
        "mel_fbank_rows": lambda: tmelfused._mel_rows_cuda(
            padded, win, fbt[:-1], wl, step, t, True, split4=True),
        "mel_short": lambda: tmelfused._mel_rows_cuda(
            padded[:-1], win, fbt, wl, step, t, True, split4=True),
        "mel_ops": lambda: tmelfused._mel_rows_cuda(
            padded, win, fbt, wl, step, t, True, mel_ops[:, :, :, :-64],
            split4=True),
        "mel_ops_exact": lambda: tmelfused._mel_rows_cuda(
            padded, win, fbt, wl, step, t, True, mel_ops, split4=False),
        "cqt_f64": lambda: tcqtslab._cqt_magnitudes_cuda(
            sig.double(), cops, 320, length, t, cf, split4=True),
        "cqt_ops": lambda: tcqtslab._cqt_magnitudes_cuda(
            sig, cops[:, :, :-1], 320, length, t, cf, split4=True),
        "cqt_ops_dtype": lambda: tcqtslab._cqt_magnitudes_cuda(
            sig, cops.double(), 320, length, t, cf, split4=True),
        "cqt_short": lambda: tcqtslab._cqt_magnitudes_cuda(
            sig[:-1], cops, 320, length, t, cf, split4=True),
        "cqt_step": lambda: tcqtslab._cqt_magnitudes_cuda(
            sig, cops, 0, length, t, cf, split4=True),
    }
    return calls[case]()


@pytest.mark.parametrize("case", [
    "rfft_f64", "rfft_ops", "full_short", "op_ops", "planes_ops",
    "planes_s4_ops", "synth_f64", "synth_width", "synth_ops", "imdct_f64",
    "mel_f64", "mel_fbank_f64", "mel_fbank_rows", "mel_short", "mel_ops",
    "mel_ops_exact", "cqt_f64", "cqt_ops", "cqt_ops_dtype", "cqt_short",
    "cqt_step"])
def test_split4_and_planes_wrappers_refuse_before_launch(case, monkeypatch):
    """The twins' and B12's CUDA wrappers check dtype, shapes and operator
    before they touch the library: non-float32 raises NotImplementedError,
    the rest ValueError; nothing is launched or counted."""
    def no_library():
        raise AssertionError("the launch was reached")

    monkeypatch.setattr(_build, "library", no_library)
    counters = (tfused.frames_rfft_split4, tfused.frames_rfft_full_split4,
                tfused.frames_op_split4, tfused.frames_matmul2,
                tfused.frames_matmul2_split4, tsynth.istft_ola_split4,
                tsynth.imdct_ola_split4, tmelfused.mel_rows,
                tmelfused.mel_rows_split4, tcqtslab.cqt_magnitudes,
                tcqtslab.cqt_magnitudes_split4)
    before = [fn.launches for fn in counters]
    error = NotImplementedError if case.endswith("_f64") else ValueError
    with pytest.raises(error):
        _bad_split4_launch(case)
    assert [fn.launches for fn in counters] == before


# ---- The device rule -------------------------------------------------------

def _entry_calls(arg):
    """One call of each public function on ``arg`` (a signal, or for istft
    and imdct the spectrum and coefficients of a 4096-sample signal)."""
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        8000).astype(np.float32))
    win, vw = hamming(512), vorbis(512)
    fb = zaftpu.melfilterbank(8000, 512, 20)
    kern = zaftpu_torch.cqtkernel(8000, 12, 110.0, 880.0)
    spec = zaftpu_torch.stft(x, win, 256)
    coeffs = zaftpu_torch.mdct(x, vw)
    return {
        "stft": lambda: zaftpu_torch.stft(arg(x), win, 256),
        "istft": lambda: zaftpu_torch.istft(arg(spec), win, 256),
        "spectrogram": lambda: zaftpu_torch.spectrogram(arg(x), win, 256),
        "mdct": lambda: zaftpu_torch.mdct(arg(x), vw),
        "imdct": lambda: zaftpu_torch.imdct(arg(coeffs), vw),
        "melspectrogram": lambda: zaftpu_torch.melspectrogram(
            arg(x), win, 256, fb),
        "mfcc": lambda: zaftpu_torch.mfcc(arg(x), win, 256, fb, 12),
        "cqtspectrogram": lambda: zaftpu_torch.cqtspectrogram(
            arg(x), 8000, 25, kern),
        "cqtchromagram": lambda: zaftpu_torch.cqtchromagram(
            arg(x), 8000, 25, 12, kern),
    }


ENTRY_POINTS = ["stft", "istft", "spectrogram", "mdct", "imdct",
                "melspectrogram", "mfcc", "cqtspectrogram", "cqtchromagram"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_device_rule_array_without_a_card_raises_cpu_tensor_runs(
        name, monkeypatch, tmp_path):
    """A numpy input goes to the card: without one it raises and says to
    pass a CPU tensor. A CPU tensor (and its windows, given as arrays) runs
    on the CPU."""
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu = _entry_calls(lambda v: v)[name]()
    assert isinstance(cpu, torch.Tensor) and cpu.device.type == "cpu"
    with pytest.raises(RuntimeError, match="pass a CPU tensor"):
        _entry_calls(lambda v: v.numpy())[name]()
