"""zaftpu_torch's fast MDCT and IMDCT + overlap-add (kernels/mdct.py,
csrc/mdct.cu) on the CPU: the twiddle tables, the plain versions against
zaftpu's frames_op and imdct_ola (Pallas interpret mode) and a float64
oracle, mdct / imdct through them against zaftpu in float32 and the
reference goldens in float64, the shape rule and its dispatch on both dials,
the refusals of the CUDA halves, and the inverse plain versions' zeros at no
frames. The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zaftpu
import zaftpu_torch
from conftest import snr_db
from test_torch_kernels import _gemm_close
from zaftpu.pallas import fused as zfused
from zaftpu.pallas import synth as zsynth
from zaftpu.transforms import mdct as zmdct
from zaftpu_torch.core.windows import vorbis
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import framing as tframing
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import irfft as tirfft
from zaftpu_torch.kernels import mdct as tkmdct
from zaftpu_torch.kernels import ola as tola
from zaftpu_torch.kernels import rfft as trfft
from zaftpu_torch.kernels import synth as tsynth

# Quarters 64 = 2^6, 275 = 5^2 11 (an odd-prime pass), 480 = 2^5 3 5 and
# 143 = 11 13 (a plan whose first pass is a prime above 7).
WINDOWS = [256, 1100, 1920, 572]


def _close(a, b):
    """The scale-aware float32 tolerance of tests/test_torch_mdct.py."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=2e-6,
                               atol=4e-6 * max(1.0, float(np.abs(a).max())))


def _primes_up_to_127(m):
    for p in range(2, 128):
        while m % p == 0:
            m //= p
    return m == 1


@pytest.mark.parametrize("n", WINDOWS + [32, 4096])
def test_twiddle_tables_are_the_references_rounded_once(n):
    """The pre-twiddle is zaftpu's forward pre-twiddle exp(-i pi m / N) at
    even m, cast to float32 as zaftpu casts it (complex64); the
    post-twiddle exp(-i pi (k + 1/4) / F) is float64 math rounded once; the
    inverse's window table is (2/F) w rounded once."""
    q, f = n // 4, n // 2
    tw = tkmdct._twiddles(n)
    assert tw.shape == (2, q, 2) and tw.dtype == np.float32
    pre = zmdct._forward_twiddles(n)[0][0:2 * q:2].astype(np.complex64)
    np.testing.assert_array_equal(tw[0, :, 0], pre.real)
    np.testing.assert_array_equal(tw[0, :, 1], pre.imag)
    post = np.exp(-1j * np.pi * (np.arange(q) + 0.25) / f)
    for got, exact in ((tw[1, :, 0], post.real), (tw[1, :, 1], post.imag)):
        assert np.all(np.abs(got - exact)
                      <= np.spacing(np.abs(got)) / 2 * (1 + 1e-9))
    win = vorbis(n)
    table = tkmdct._synthesis_window(win.tobytes())
    np.testing.assert_array_equal(table, (win * (2.0 / f)).astype(np.float32))
    assert tkmdct._twiddles(n, "float64").dtype == np.float64


@pytest.mark.parametrize("n", WINDOWS + [32, 2048, 4096])
def test_kernel_tables_start_with_the_fft_twiddle_table(n):
    """The CUDA entries take kernels/rfft.kernel_tables(N/2): its first N/2
    rows are the table of W_{N/2} that the plain versions' passes read
    (rfft.twiddles(N/2)), entry for entry, and the rest the Q-point FFT's
    per-pass tables, gathered from it with no new rounding."""
    f, q = n // 2, n // 4
    tab = trfft.kernel_tables(f, "cpu")
    assert tab.dtype == torch.float32
    assert torch.equal(tab[:f], trfft.twiddles(f, torch.float32, "cpu"))
    passes = tab[f:].numpy()
    np.testing.assert_array_equal(passes, trfft._pass_tables(q, f))
    ns, rows = 1, 0
    for r in trfft.radices(q):
        rows += (r - 1) * ns
        ns *= r
    assert passes.shape == (rows, 2)
    assert np.isin(passes.view(np.int64), tab[:f].numpy().view(
        np.int64)).all()


def test_fits_is_its_definition():
    """A multiple of 4 from 32 to 4096 whose quarter has no prime factor
    above 127: 724 of the 1,017 multiples of 4 in that range."""
    want = [n for n in range(1, 4201) if n % 4 == 0 and 32 <= n <= 4096
            and _primes_up_to_127(n // 4)]
    got = [n for n in range(1, 4201) if tkmdct.fits(n)]
    assert got == want and len(got) == 724
    for n in (256, 512, 1024, 1920, 2048, 4096, 1100, 1764, 2060, 4088):
        assert tkmdct.fits(n)
    for n in (1102, 2062, 524, 4100, 28, 30):
        assert not tkmdct.fits(n)


def _oracle_forward(padded, win, wl, t):
    f = wl // 2
    frames = np.stack([padded[..., i * f:i * f + wl] for i in range(t)], -2)
    return (frames.astype(np.float64) * win) @ zmdct._direct_forward_matrix(wl)


def _oracle_inverse(coeffs, win64, f):
    frames = (coeffs.astype(np.float64) @ zmdct._direct_inverse_matrix(f)
              ) * win64
    t = coeffs.shape[-2]
    out = np.zeros((*coeffs.shape[:-2], (t + 1) * f))
    for i in range(t):
        out[..., i * f:i * f + 2 * f] += frames[..., i, :]
    return out


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("wl", WINDOWS)
def test_mdct_fft_plain_matches_zaftpu_frames_op(wl, lead):
    """The forward's plain version against zaftpu's B2 (frames_op with the
    MDCT operator, interpret mode) on the same seeded float32 input, row by
    row, with a float64 oracle naming the side at fault."""
    f, t = wl // 2, 9
    rng = np.random.default_rng(wl + len(lead))
    padded = rng.standard_normal((*lead, (t + 1) * f)).astype(np.float32)
    win = vorbis(wl).astype(np.float32)
    calls = tkmdct.mdct_fft_plain.calls
    mine = tkmdct.mdct_fft(torch.from_numpy(padded), torch.from_numpy(win),
                           wl, t)
    assert tkmdct.mdct_fft_plain.calls == calls + 1
    assert mine.shape == (*lead, t, f) and mine.dtype == torch.float32
    oracle = _oracle_forward(padded, win, wl, t)
    for idx in np.ndindex(*lead):
        ref = np.asarray(zfused.frames_op(
            jnp.array(padded[idx]), jnp.array(win),
            zmdct._direct_forward_ops_padded, f, wl, f, t, interpret=True))
        _gemm_close(mine[idx].numpy(), ref, oracle[idx])


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("wl", WINDOWS)
def test_imdct_ola_fft_plain_matches_zaftpu_imdct_ola(wl, lead):
    """The inverse's plain version against zaftpu's B7 (imdct_ola,
    interpret mode) on the same seeded float32 coefficients, with a float64
    oracle naming the side at fault."""
    f, t = wl // 2, 9
    rng = np.random.default_rng(wl + 7 + len(lead))
    coeffs = rng.standard_normal((*lead, t, f)).astype(np.float32)
    win = vorbis(wl)
    calls = tkmdct.imdct_ola_fft_plain.calls
    mine = tkmdct.imdct_ola_fft(torch.from_numpy(coeffs), f, win.tobytes())
    assert tkmdct.imdct_ola_fft_plain.calls == calls + 1
    assert mine.shape == (*lead, (t + 1) * f) and mine.dtype == torch.float32
    oracle = _oracle_inverse(coeffs, win, f)
    for idx in np.ndindex(*lead):
        ref = np.asarray(zsynth.imdct_ola(jnp.array(coeffs[idx]), f,
                                          win.tobytes(), interpret=True))
        _gemm_close(mine[idx].numpy(), ref, oracle[idx])


@pytest.mark.parametrize("wl", WINDOWS)
def test_plain_versions_match_the_float64_matrices(wl):
    """In float64 both plain versions are the MDCT and the windowed TDAC
    overlap-add of the reference's matrices to 1e-13 of max."""
    f, t = wl // 2, 7
    rng = np.random.default_rng(wl + 11)
    padded = rng.standard_normal((2, (t + 1) * f))
    win = vorbis(wl)
    got = tkmdct.mdct_fft_plain(torch.from_numpy(padded),
                                torch.from_numpy(win), wl, t).numpy()
    ref = _oracle_forward(padded, win, wl, t)
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    coeffs = rng.standard_normal((2, t, f))
    got = tkmdct.imdct_ola_fft_plain(torch.from_numpy(coeffs), f,
                                     win.tobytes()).numpy()
    ref = _oracle_inverse(coeffs, win, f)
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()


def _fft_calls():
    return (tkmdct.mdct_fft_plain.calls, tkmdct.imdct_ola_fft_plain.calls)


def test_f64_goldens_through_the_fast_mdct(golden, signal):
    """mdct and imdct at vorbis(2048) take the fast plain versions and meet
    the reference goldens at tests/test_torch_mdct.py's 1e-12."""
    win = vorbis(2048)
    before = _fft_calls()
    coeffs = zaftpu_torch.mdct(torch.from_numpy(signal), win)
    rec = zaftpu_torch.imdct(torch.from_numpy(golden["mdct"]), win)
    assert _fft_calls() == (before[0] + 1, before[1] + 1)
    assert coeffs.dtype == rec.dtype == torch.float64
    np.testing.assert_allclose(coeffs.numpy(), golden["mdct"], atol=1e-12)
    np.testing.assert_allclose(rec.numpy(), golden["imdct"], atol=1e-12)


@pytest.mark.parametrize("wl", [2048] + WINDOWS + [1764])
def test_f32_matches_zaftpu_through_the_fast_mdct(signal, wl):
    """float32 mdct and imdct through the fast plain versions against
    zaftpu's, at tests/test_torch_mdct.py's tolerance, and a round trip
    above 120 dB."""
    x32 = signal.astype(np.float32)
    w32 = vorbis(wl).astype(np.float32)
    before = _fft_calls()
    mine = zaftpu_torch.mdct(torch.from_numpy(x32), w32)
    ref = np.asarray(zaftpu.mdct(x32, w32))
    assert mine.dtype == torch.float32 and tuple(mine.shape) == ref.shape
    _close(mine.numpy(), ref)
    rec = zaftpu_torch.imdct(torch.from_numpy(ref.copy()), w32)
    ref_rec = np.asarray(zaftpu.imdct(ref, w32))
    assert tuple(rec.shape) == ref_rec.shape
    _close(rec.numpy(), ref_rec)
    assert _fft_calls() == (before[0] + 1, before[1] + 1)
    own = zaftpu_torch.imdct(mine, w32).numpy().astype(np.float64)
    assert snr_db(x32.astype(np.float64), own) > 120.0


def _plain_calls():
    return {"mdct_fft": tkmdct.mdct_fft_plain.calls,
            "imdct_ola_fft": tkmdct.imdct_ola_fft_plain.calls,
            "frames_op": tfused.frames_op_plain.calls,
            "imdct_ola": tsynth.imdct_ola_plain.calls,
            "frames_op_split4": tfused.frames_op_split4_plain.calls,
            "imdct_ola_split4": tsynth.imdct_ola_split4_plain.calls,
            "framing": tframing.frame_window_plain.calls,
            "ola": tola.overlap_add_plain.calls}


def _launches():
    return (tkmdct.mdct_fft.launches, tkmdct.imdct_ola_fft.launches,
            tfused.frames_op.launches, tsynth.imdct_ola.launches,
            tfused.frames_op_split4.launches,
            tsynth.imdct_ola_split4.launches)


@pytest.mark.parametrize("dial", ["highest", "split4"])
@pytest.mark.parametrize("wl,env,want", [
    (256, {}, ("mdct_fft", "imdct_ola_fft")),
    (1100, {}, ("mdct_fft", "imdct_ola_fft")),
    (1102, {}, ("frames_op", "imdct_ola")),
    (524, {}, ("frames_op", "imdct_ola")),
    (256, {"ZAFTPU_FFT": "matmul"}, ("frames_op", "imdct_ola")),
    (256, {"ZAFTPU_FFT": "native"}, ("mdct_fft", "imdct_ola_fft")),
    (256, {"ZAFTPU_FUSED": "0"}, ("framing", "imdct_ola_fft")),
    (256, {"ZAFTPU_SYNTH": "0"}, ("mdct_fft", "ola"))])
def test_rule_dispatch_on_both_dials(wl, env, want, dial, monkeypatch):
    """On both dials the fast kernels take mdct / imdct at a window the
    rule takes; WL 1102 (F odd) and 524 (quarter 131) take B2 and B7 (their
    twins under split4), as does ZAFTPU_FFT=matmul; ZAFTPU_FUSED=0 and
    ZAFTPU_SYNTH=0 keep the framing and OLA paths for their half. Exactly
    the wanted plain versions run, once each, and nothing launches."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = tuple(w + "_split4" if dial == "split4"
                 and w in ("frames_op", "imdct_ola") else w for w in want)
    win = vorbis(wl).astype(np.float32)
    x = torch.from_numpy(np.random.default_rng(wl).standard_normal(
        3 * wl).astype(np.float32))
    before, launches = _plain_calls(), _launches()
    coeffs = zaftpu_torch.mdct(x, win)
    zaftpu_torch.imdct(coeffs, win)
    moved = {k: v - before[k] for k, v in _plain_calls().items()
             if v != before[k]}
    assert moved == dict.fromkeys(want, 1)
    assert _launches() == launches


def test_an_explicit_operator_names_b7(monkeypatch):
    """imdct_ola with an operator runs B7 (B7-s4 under split4) at a rule
    window, and matches the fast kernel's plain version to float32
    rounding."""
    f, t = 128, 9
    coeffs = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (t, f)).astype(np.float32))
    wb = vorbis(2 * f).tobytes()
    fast = tsynth.imdct_ola(coeffs, f, wb)
    for dial, name in (("highest", "imdct_ola"),
                       ("split4", "imdct_ola_split4")):
        monkeypatch.setenv("ZAFTPU_PRECISION", dial)
        before = _plain_calls()
        gemm = tsynth.imdct_ola(coeffs, f, wb, ops=tsynth.imdct_ops(
            f, wb, torch.float32, "cpu"))
        assert _plain_calls()[name] == before[name] + 1
        tol = 2e-6 if dial == "highest" else 1e-4
        assert float((gemm - fast).abs().max()) <= tol * float(
            fast.abs().max())


def test_inverse_plain_versions_return_zeros_for_no_frames():
    """No frames: the inverse FFT + OLA plain versions return N - step
    (istft) and F (imdct) zeros a row, as B4 and B7 do."""
    n, step = 256, 64
    h = torch.zeros((2, 0, n // 2 + 1))
    out = tirfft.istft_ola_fft_plain(h, h, n, step, 0.5)
    assert out.shape == (2, n - step) and not out.any()
    out = tirfft.istft_ola_fft(h[0], h[0], n, step, 0.5)
    assert out.shape == (n - step,) and not out.any()
    f = 128
    out = tkmdct.imdct_ola_fft(torch.zeros((3, 0, f)), f, vorbis(2 * f)
                               .tobytes())
    assert out.shape == (3, f) and not out.any()


def _bad_call(case):
    """Call a CUDA half with one bad argument (CPU tensors)."""
    wl, t = 256, 9
    padded = torch.zeros((t + 1) * wl // 2)
    win = torch.zeros(wl)
    coeffs = torch.zeros(t, wl // 2)
    wb = np.ones(wl).tobytes()
    calls = {
        "mdct_f64": lambda: tkmdct._mdct_fft_cuda(padded.double(), win, wl,
                                                  t),
        "mdct_window": lambda: tkmdct._mdct_fft_cuda(padded, win[:-4], wl, t),
        "mdct_short": lambda: tkmdct._mdct_fft_cuda(padded[:-1], win, wl, t),
        "mdct_length": lambda: tkmdct._mdct_fft_cuda(
            torch.zeros(10 * 551), torch.zeros(1102), 1102, 9),
        "imdct_f64": lambda: tkmdct._imdct_ola_fft_cuda(coeffs.double(),
                                                        wl // 2, wb),
        "imdct_width": lambda: tkmdct._imdct_ola_fft_cuda(coeffs[:, :-1],
                                                          wl // 2, wb),
        "imdct_window": lambda: tkmdct._imdct_ola_fft_cuda(coeffs, wl // 2,
                                                           wb[:-8]),
        "imdct_length": lambda: tkmdct._imdct_ola_fft_cuda(
            torch.zeros(t, 551), 551, np.ones(1102).tobytes()),
    }
    return calls[case]()


@pytest.mark.parametrize("case", [
    "mdct_f64", "mdct_window", "mdct_short", "mdct_length", "imdct_f64",
    "imdct_width", "imdct_window", "imdct_length"])
def test_cuda_halves_refuse_before_launch(case, monkeypatch):
    """The CUDA halves check dtype, window, length and shapes before they
    touch the library: non-float32 raises NotImplementedError, the rest
    ValueError; nothing is launched."""
    def no_library():
        raise AssertionError("the launch was reached")

    monkeypatch.setattr(_build, "library", no_library)
    launches = _launches()
    error = NotImplementedError if case.endswith("_f64") else ValueError
    with pytest.raises(error):
        _bad_call(case)
    assert _launches() == launches

