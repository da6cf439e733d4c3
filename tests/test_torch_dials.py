"""The precision dials ``high`` and ``default`` and the bf16 compute dtype
(``compute_dtype`` / ``ZAFTPU_DTYPE``) in zaftpu_torch, against zaftpu.

``policy.split_matmul`` at 4, 3 and 1 passes against a numpy model of the
kept bf16 products; the pass counts each dial gives on each device; the
twins' plain versions at 3 and 1 passes; the public transforms under
``high`` and ``default`` on the CPU (exact there, as zaftpu's CPU backend
is) against zaftpu's; tests/test_bf16.py's compute-dtype cases mirrored
against the port (the exempt mel front ends, the CQT lowered on B10's route
and kept exact on the spectral kernel, the context, the environment
variable, a refused dtype, float64 never lowered); ``DispatchConfig``. The
twins' CUDA kernels at 3 and 1 passes run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

import zaftpu
import zaftpu_torch
from conftest import snr_db
from zaftpu.config import DispatchConfig as ZDispatchConfig
from zaftpu.core import policy as zpolicy
from zaftpu.core.windows import hamming, vorbis
from zaftpu_torch.core import policy
from zaftpu_torch.kernels import cqtslab as tcqtslab
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import melfused as tmelfused
from zaftpu_torch.kernels import synth as tsynth

SR, WL, STEP = 44100, 2048, 1024
DIALS = ("high", "default")


def _np(x):
    return x.detach().cpu().numpy()


def _close(a, b):
    """tests/test_config_api.py's scale-aware allclose."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=2e-6,
                               atol=4e-6 * max(1.0, float(np.abs(a).max())))


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path))


@pytest.fixture
def dial(request, monkeypatch):
    """ZAFTPU_PRECISION set for both packages; zaftpu reads it at trace
    time, so its caches are cleared around the test."""
    monkeypatch.setenv("ZAFTPU_PRECISION", request.param)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


@pytest.fixture(scope="module")
def x32():
    return np.random.default_rng(0).standard_normal(SR * 2).astype(np.float32)


# ---- split_matmul ---------------------------------------------------------

def _model(a, b, passes):
    """The kept bf16 products of ``a @ b`` in float64: the hi/lo halves of
    policy.bf16_split_host (float32 values that are bf16 values)."""
    ah, al = (h.astype(np.float64) for h in policy.bf16_split_host(a))
    bh, bl = (h.astype(np.float64) for h in policy.bf16_split_host(b))
    terms = {1: [ah @ bh], 3: [al @ bh, ah @ bl, ah @ bh],
             4: [al @ bl, al @ bh, ah @ bl, ah @ bh]}[passes]
    return sum(terms)


@pytest.mark.parametrize("passes", [4, 3, 1])
@pytest.mark.parametrize("shape", [(7, 300, 5), (33, 1024, 260),
                                   (2, 16, 1)])
def test_split_matmul_keeps_the_dials_bf16_products(passes, shape):
    """Each product of two bf16 values is exact in FP32, so the port
    differs from the float64 sum of exactly the kept products only by its
    float32 sums: within 1e-6 of the result's scale."""
    m, k, n = shape
    rng = np.random.default_rng(m + k + n + passes)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    mine = _np(policy.split_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                   passes)).astype(np.float64)
    ref = _model(a, b, passes)
    np.testing.assert_allclose(mine, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    # Dropping terms costs accuracy in the order the dials promise.
    exact = a.astype(np.float64) @ b.astype(np.float64)
    err = np.abs(mine - exact).max() / np.abs(exact).max()
    assert err < {4: 1e-5, 3: 1e-5, 1: 2e-2}[passes]
    if passes == 1:
        assert err > 1e-4


def test_split_matmul_refuses_other_pass_counts():
    a, b = torch.ones((2, 3)), torch.ones((3, 2))
    for passes in (0, 2, 5):
        with pytest.raises(ValueError, match="1, 3 or 4"):
            policy.split_matmul(a, b, passes)
    # One pass never reads the lo half.
    hi = b.to(torch.bfloat16)
    assert torch.equal(policy.split_matmul_presplit(a, hi, None, 1),
                       policy.exact_matmul(a, b))


@pytest.mark.parametrize("value,want", [
    (None, None), ("highest", None), ("split4", 4), ("high", 3),
    ("default", 1), ("HIGH", 3)])
def test_passes_and_gemm_passes(value, want, monkeypatch):
    """``passes`` follows zaftpu's dial names; ``gemm_passes`` lowers only
    float32, and high / default only on CUDA (exact on the CPU, as zaftpu's
    CPU backend runs them)."""
    if value is None:
        monkeypatch.delenv("ZAFTPU_PRECISION", raising=False)
    else:
        monkeypatch.setenv("ZAFTPU_PRECISION", value)
    assert policy.passes() == want
    assert policy.gemm_passes(torch.float32, "cuda") == want
    assert policy.gemm_passes(torch.float64, "cuda") is None
    assert policy.gemm_passes(torch.float32, "cpu") == (
        4 if want == 4 else None)
    # zaftpu's names for the same dials.
    table = {None: "HIGHEST", "highest": "HIGHEST", "split4": "HIGHEST",
             "high": "HIGH", "default": "DEFAULT", "HIGH": "HIGH"}
    assert zpolicy.matmul_precision().name == table[value]


@pytest.mark.parametrize("dial", DIALS, indirect=True)
def test_real_matmul_exact_on_cpu_under_pass_count_dials(dial):
    """On the CPU high and default run exact_matmul, narrow or wide."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((9, 512)).astype(np.float32))
    for n in (40, 300):
        b = torch.from_numpy(rng.standard_normal((512, n)).astype(
            np.float32))
        assert torch.equal(policy.real_matmul(a, b),
                           policy.exact_matmul(a, b))


# ---- The twins' plain versions at 3 and 1 passes -------------------------

def _twin_cases():
    """(name, plain version taking ``passes``, its arguments, exact plain
    version) for the eight twins, at a small ragged shape."""
    rng = np.random.default_rng(5)
    wl, step, t = 256, 100, 9
    padded = torch.from_numpy(rng.standard_normal(
        (t - 1) * step + wl).astype(np.float32))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    frames = (padded, win, wl, step, t)
    ops = tfused.rdft_ops(wl, torch.float32, "cpu")
    mops = torch.from_numpy(rng.standard_normal((1, wl, 128)).astype(
        np.float32))
    half = torch.from_numpy(rng.standard_normal((t, wl // 2 + 1)).astype(
        np.float32))
    coeffs = torch.from_numpy(rng.standard_normal((t, 64)).astype(
        np.float32))
    wb = vorbis(128).tobytes()
    fbank_t = torch.from_numpy(np.abs(rng.standard_normal(
        (wl // 2, 12))).astype(np.float32))
    cqt_ops = torch.from_numpy(rng.standard_normal((2, 512, 64)).astype(
        np.float32))
    cqt_sig = torch.from_numpy(rng.standard_normal(
        tcqtslab.slab_needed(t, 40, 512)).astype(np.float32))
    return [
        ("fused", tfused.frames_rfft_split4_plain, (*frames, ops),
         tfused.frames_rfft_plain, (*frames, ops)),
        ("frames_rfft_full", tfused.frames_rfft_full_split4_plain,
         (*frames, ops), tfused.frames_rfft_full_plain, (*frames, ops)),
        ("frames_matmul2", tfused.frames_matmul2_split4_plain,
         (*frames, ops), tfused.frames_matmul2_plain, (*frames, ops)),
        ("frames_op", tfused.frames_op_split4_plain,
         (padded, win, mops, 100, wl, step, t), tfused.frames_op_plain,
         (padded, win, mops, 100, wl, step, t)),
        ("synth", tsynth.istft_ola_split4_plain, (half, half, wl, 64, 0.5),
         tsynth.istft_ola_plain, (half, half, wl, 64, 0.5)),
        ("imdct_ola", tsynth.imdct_ola_split4_plain, (coeffs, 64, wb),
         tsynth.imdct_ola_plain, (coeffs, 64, wb)),
        ("mel_rows", tmelfused.mel_rows_split4_plain,
         (*frames[:2], fbank_t, wl, step, t, False),
         tmelfused.mel_rows_plain, (*frames[:2], fbank_t, wl, step, t,
                                    False)),
        ("cqt_magnitudes", tcqtslab.cqt_magnitudes_split4_plain,
         (cqt_sig, cqt_ops, 40, 512, t, 60), tcqtslab.cqt_magnitudes_plain,
         (cqt_sig, cqt_ops, 40, 512, t, 60)),
    ]


def _flat(x):
    x = torch.stack(x) if isinstance(x, tuple) else x
    return _np(torch.view_as_real(x) if x.is_complex() else x).astype(
        np.float64)


@pytest.mark.parametrize("index", range(8))
def test_twin_plain_versions_take_the_pass_count(index):
    """Each twin's plain version at 3 passes stays within split4's reach
    of the exact plain version, at 1 pass within bf16's and no closer; 4
    is the default."""
    name, twin, args, exact, exact_args = _twin_cases()[index]
    ref = _flat(exact(*exact_args))
    scale = np.abs(ref).max()
    errs = {}
    for passes in (4, 3, 1):
        got = _flat(twin(*args, passes=passes))
        assert got.shape == ref.shape, name
        errs[passes] = np.abs(got - ref).max() / scale
    assert np.array_equal(_flat(twin(*args)), _flat(twin(*args, passes=4)))
    assert errs[4] < 2e-5 and errs[3] < 2e-5, (name, errs)
    assert 1e-4 < errs[1] < 3e-2, (name, errs)


# ---- The public transforms under high and default on the CPU -------------

@pytest.mark.parametrize("dial", DIALS, indirect=True)
@pytest.mark.parametrize("wl", [512, 262])
def test_stft_istft_match_zaftpu_under_dial(dial, wl, x32):
    win = hamming(wl).astype(np.float32)
    step = wl // 2
    mine = zaftpu_torch.stft(torch.from_numpy(x32), win, step)
    ref = np.asarray(zaftpu.stft(x32, win, step))
    _close(_np(mine), ref)
    _close(_np(zaftpu_torch.istft(mine, win, step)),
           np.asarray(zaftpu.istft(ref, win, step)))


@pytest.mark.parametrize("dial", DIALS, indirect=True)
@pytest.mark.parametrize("wl", [512, 1100])
def test_mdct_imdct_match_zaftpu_under_dial(dial, wl, x32):
    win = vorbis(wl).astype(np.float32)
    mine = zaftpu_torch.mdct(torch.from_numpy(x32), win)
    ref = np.asarray(zaftpu.mdct(x32, win))
    _close(_np(mine), ref)
    _close(_np(zaftpu_torch.imdct(mine, win)),
           np.asarray(zaftpu.imdct(ref, win)))


@pytest.mark.parametrize("dial", DIALS, indirect=True)
def test_cqt_matches_zaftpu_under_dial(dial, cache_dir):
    x = np.random.default_rng(4).standard_normal(16000).astype(np.float32)
    kern = zaftpu.cqtkernel(8000, 12, 110.0, 880.0)
    mine = zaftpu_torch.cqtspectrogram(
        torch.from_numpy(x), 8000, 25,
        zaftpu_torch.cqtkernel(8000, 12, 110.0, 880.0))
    ref = np.asarray(zaftpu.cqtspectrogram(x, 8000, 25, kern))
    np.testing.assert_allclose(_np(mine), ref,
                               atol=2e-6 * np.abs(ref).max())


# ---- compute_dtype (tests/test_bf16.py against the port) ------------------

@pytest.fixture(scope="module")
def fbank():
    return zaftpu_torch.melfilterbank(SR, WL, 40)


@pytest.fixture
def bf16_env(monkeypatch):
    monkeypatch.delenv("ZAFTPU_DTYPE", raising=False)
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_bf16_flag_and_exports():
    assert zaftpu_torch.BF16_SUPPORTED is zaftpu.BF16_SUPPORTED
    assert zaftpu_torch.compute_dtype is policy.compute_dtype
    assert policy.BF16_EXEMPT == zpolicy.BF16_EXEMPT
    for name in ("wavread", "wavwrite", "compute_dtype", "DispatchConfig",
                 "BF16_SUPPORTED"):
        assert name in zaftpu_torch.__all__


@pytest.mark.parametrize("fn", ["melspectrogram", "mfcc"])
def test_mel_front_ends_bf16_exempt(fn, x32, fbank, bf16_env):
    """The exempt front ends are bit-equal under the bf16 dtype."""
    win = hamming(WL).astype(np.float32)
    x = torch.from_numpy(x32)

    def run():
        if fn == "mfcc":
            return zaftpu_torch.mfcc(x, win, STEP, fbank, 20)
        return zaftpu_torch.melspectrogram(x, win, STEP, fbank)

    ref = run()
    with zaftpu_torch.compute_dtype("bfloat16"):
        got = run()
    assert got.dtype == torch.float32
    assert torch.equal(got, ref)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_cqt_bf16_on_b10_route_matches_zaftpu(lead, bf16_env, cache_dir,
                                               monkeypatch):
    """Under ZAFTPU_FFT=matmul (where cqtfft.applies is false on the CPU
    too) the port's CQT lowers as zaftpu's does: the signal rounded to
    bf16, the operator's hi half, one pass, float32 sums."""
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    x = np.random.default_rng(6).standard_normal((*lead, 24000)).astype(
        np.float32)
    zk = zaftpu.cqtkernel(8000, 12, 110.0, 880.0)
    tk = zaftpu_torch.cqtkernel(8000, 12, 110.0, 880.0)
    exact = _np(zaftpu_torch.cqtspectrogram(torch.from_numpy(x), 8000, 25,
                                            tk))
    calls = tcqtslab.cqt_magnitudes_split4_plain.calls
    with zaftpu_torch.compute_dtype("bf16"), zaftpu.compute_dtype("bf16"):
        mine = _np(zaftpu_torch.cqtspectrogram(torch.from_numpy(x), 8000,
                                               25, tk))
        ref = np.stack([np.asarray(zaftpu.cqtspectrogram(row, 8000, 25, zk))
                        for row in x.reshape(-1, x.shape[-1])]).reshape(
                            mine.shape)
    assert tcqtslab.cqt_magnitudes_split4_plain.calls > calls
    assert mine.dtype == np.float32
    np.testing.assert_allclose(mine, ref, atol=1e-4 * np.abs(ref).max())
    assert 40 < snr_db(exact.ravel(), mine.ravel()) < 80


def test_cqt_bf16_at_power_of_two_keeps_the_spectral_kernel(x32, bf16_env,
                                                            cache_dir):
    """At CqtConfig()'s L 32,768 the port keeps its exact spectral route
    under the bf16 dtype; zaftpu's lowered result is within
    tests/test_bf16.py's 45 dB of it."""
    kern = zaftpu.cqtkernel(SR, 24, 55.0, 3520.0)
    x = torch.from_numpy(x32)
    tk = zaftpu_torch.cqtkernel(SR, 24, 55.0, 3520.0)
    exact = _np(zaftpu_torch.cqtspectrogram(x, SR, 25, tk))
    with zaftpu_torch.compute_dtype("bfloat16"), \
            zaftpu.compute_dtype("bfloat16"):
        mine = _np(zaftpu_torch.cqtspectrogram(x, SR, 25, tk))
        theirs = np.asarray(zaftpu.cqtspectrogram(x32, SR, 25, kern))
    np.testing.assert_array_equal(mine, exact)
    assert snr_db(mine.ravel(), theirs.ravel()) > 45.0


def test_compute_dtype_context_restores(fbank, bf16_env):
    assert policy.matmul_dtype() is None
    with zaftpu_torch.compute_dtype("bfloat16"):
        assert policy.matmul_dtype() is torch.bfloat16
        with zaftpu_torch.compute_dtype(None):
            assert policy.matmul_dtype() is None
        assert policy.matmul_dtype() is torch.bfloat16
    assert policy.matmul_dtype() is None
    with pytest.raises(RuntimeError):
        with zaftpu_torch.compute_dtype("bf16"):
            raise RuntimeError
    assert policy.matmul_dtype() is None


def test_env_var_path(bf16_env, cache_dir, monkeypatch):
    """ZAFTPU_DTYPE=bfloat16 gives the context's result; float32 inside
    a context pins float32 against it."""
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        16000).astype(np.float32))
    tk = zaftpu_torch.cqtkernel(8000, 12, 110.0, 880.0)
    exact = zaftpu_torch.cqtspectrogram(x, 8000, 25, tk)
    with zaftpu_torch.compute_dtype("bfloat16"):
        ref = zaftpu_torch.cqtspectrogram(x, 8000, 25, tk)
    monkeypatch.setenv("ZAFTPU_DTYPE", "bfloat16")
    assert policy.matmul_dtype() is torch.bfloat16
    assert torch.equal(zaftpu_torch.cqtspectrogram(x, 8000, 25, tk), ref)
    with zaftpu_torch.compute_dtype("float32"):
        assert policy.matmul_dtype() is None
        assert torch.equal(zaftpu_torch.cqtspectrogram(x, 8000, 25, tk),
                           exact)
    assert not torch.equal(ref, exact)


@pytest.mark.parametrize("value", ["int8", "float16", "fp8"])
def test_invalid_dtype_rejected(value):
    with pytest.raises(ValueError, match="bfloat16") as mine:
        with zaftpu_torch.compute_dtype(value):
            pass
    with pytest.raises(ValueError) as ref:
        with zaftpu.compute_dtype(value):
            pass
    assert str(mine.value) == str(ref.value)


def test_f64_oracle_never_lowered(fbank, bf16_env, cache_dir, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    x64 = torch.from_numpy(np.random.default_rng(1).standard_normal(SR))
    win = hamming(WL)
    tk = zaftpu_torch.cqtkernel(8000, 12, 110.0, 880.0)
    mel = zaftpu_torch.melspectrogram(x64, win, STEP, fbank)
    cqt = zaftpu_torch.cqtspectrogram(x64[:16000], 8000, 25, tk)
    with zaftpu_torch.compute_dtype("bfloat16"):
        assert policy.operator_dtype(torch.float64) == torch.float64
        assert policy.operator_dtype(torch.float32) == torch.bfloat16
        assert (policy.operator_dtype(torch.float32, "mfcc")
                == torch.float32)
        got = zaftpu_torch.melspectrogram(x64, win, STEP, fbank)
        assert torch.equal(
            zaftpu_torch.cqtspectrogram(x64[:16000], 8000, 25, tk), cqt)
    assert got.dtype == torch.float64
    assert torch.equal(got, mel)


def test_mxu_matmul_matches_zaftpus():
    """A bf16 operator: the activation rounded to bf16, one pass, float32
    sums (zaftpu's CPU emulation of the MXU pass); a float32 one goes
    through real_matmul."""
    import jax.numpy as jnp
    import ml_dtypes

    rng = np.random.default_rng(9)
    a = rng.standard_normal((20, 700)).astype(np.float32)
    b = rng.standard_normal((700, 30)).astype(np.float32)
    b16 = b.astype(ml_dtypes.bfloat16)
    mine = _np(policy.mxu_matmul(torch.from_numpy(a),
                                 torch.from_numpy(b16.astype(np.float32))
                                 .to(torch.bfloat16)))
    ref = np.asarray(zpolicy.mxu_matmul(jnp.asarray(a), jnp.asarray(b16)))
    assert mine.dtype == np.float32
    np.testing.assert_allclose(mine, ref, atol=1e-6 * np.abs(ref).max())
    assert torch.equal(
        policy.mxu_matmul(torch.from_numpy(a), torch.from_numpy(b)),
        policy.exact_matmul(torch.from_numpy(a), torch.from_numpy(b)))


# ---- DispatchConfig -------------------------------------------------------

@pytest.mark.parametrize("env", [
    {}, {"ZAFTPU_PRECISION": "high"}, {"ZAFTPU_PRECISION": "default",
                                       "ZAFTPU_FFT": "matmul"},
    {"ZAFTPU_PRECISION": "split4", "ZAFTPU_CQT_SCHEME": "exact",
     "ZAFTPU_MELFUSE": "1", "ZAFTPU_FULLSPEC": "0"},
    {"ZAFTPU_DTYPE": "bf16", "ZAFTPU_MIRROR": "pallas",
     "ZAFTPU_FUSED2": "1", "ZAFTPU_SYNTH": "0", "ZAFTPU_FUSED": "0"}])
def test_dispatch_config_reflects_the_levers(env, monkeypatch, bf16_env):
    for name in ("ZAFTPU_PRECISION", "ZAFTPU_FFT", "ZAFTPU_CQT_SCHEME",
                 "ZAFTPU_MELFUSE", "ZAFTPU_FULLSPEC", "ZAFTPU_DTYPE",
                 "ZAFTPU_MIRROR", "ZAFTPU_FUSED2", "ZAFTPU_SYNTH",
                 "ZAFTPU_FUSED"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    mine = zaftpu_torch.DispatchConfig.current()
    ref = ZDispatchConfig.current()
    for field in mine.__dataclass_fields__:
        assert getattr(mine, field) == getattr(ref, field), field
    assert hash(mine) == hash(zaftpu_torch.DispatchConfig.current())
    with pytest.raises(Exception):
        mine.precision = "x"
    with zaftpu_torch.compute_dtype("bfloat16"), \
            zaftpu.compute_dtype("bfloat16"):
        inside = zaftpu_torch.DispatchConfig.current()
        assert inside.matmul_dtype == "bfloat16"
        assert inside.matmul_dtype == ZDispatchConfig.current().matmul_dtype
    with zaftpu_torch.compute_dtype("float32"):
        assert zaftpu_torch.DispatchConfig.current().matmul_dtype == ""
