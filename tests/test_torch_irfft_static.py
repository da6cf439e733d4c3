"""The static inverse real-FFT + overlap-add kernel's three loads
(zaftpu_torch/kernels/irfft.py): the fused fold (the full spectrum, the
Hermitian fold read in the kernel's load), the folded planes and the
complex half spectrum of Griffin-Lim's windowed store, on the CPU.

The fused fold's plain version against zaftpu (``zaftpu.core.fft.
hermitian_fold_planes``, then its fused synthesis ``istft_ola`` in interpret
mode where that kernel takes the hop, else its split path) and bit-equal to
the index fold followed by the planes' plain version; the windowed store's
complex plain version bit-equal to the planes version it replaces; the
synthesis route by counters on every lever; the checks the wrappers make
before a launch. The CUDA kernel runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py hold it against these plain
versions there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zaftpu
import zaftpu_torch
from zaftpu.core import fft as zfft
from zaftpu.core import frame as zframe
from zaftpu.core.windows import hamming
from zaftpu.pallas import synth as zsynth
from zaftpu_torch.core import fft as tfft
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import irfft as tirfft
from zaftpu_torch.kernels import mirror as tmirror
from zaftpu_torch.kernels import rfft as trfft
from zaftpu_torch.kernels import synth as tsynth

SCALE = 0.7310586
# tests/test_torch_irfft.py's ZAFTPU_CASES: WL, hop, T, leading axes.
ZAFTPU_CASES = [(16, 8, 11, (2,)), (16, 4, 1, ()), (24, 6, 11, (2,)),
                (400, 160, 11, (2,)), (400, 200, 1, ()), (882, 441, 11, ()),
                (1764, 882, 7, (2,)), (2048, 1024, 5, ()),
                (2048, 512, 1, (2,)), (3000, 1000, 4, ()),
                (220, 110, 11, (2,)), (254, 100, 7, ()), (1102, 551, 7, ()),
                (2662, 1331, 3, ()), (2822, 1411, 4, (2,))]
LAYOUTS = ["frames-major", "bins-major", "column slice"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain versions' many small operations ran
    far slower when the test workers' OpenMP threads oversubscribed the
    cores (tests/test_torch_irfft_any.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _full(lead, wl, t, seed, layout="frames-major", dtype=np.float32):
    """A full spectrum ``(*lead, t, wl)`` that is not Hermitian, in
    ``layout``: frames-major, the transposed view of a bins-major tensor,
    or a column slice of one (its frames from the second on)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((2, *lead, t + 2, wl)).astype(dtype)
    full = torch.complex(torch.from_numpy(z[0]), torch.from_numpy(z[1]))
    if layout != "frames-major":
        full = full.transpose(-1, -2).contiguous().transpose(-1, -2)
    return full[..., 1:t + 1, :] if layout == "column slice" else \
        full[..., :t, :]


def _zaftpu_ola(zr, zi, wl, step):
    """zaftpu's synthesis of one row's full spectrum ``(T, N)``: its fold,
    then its fused synthesis kernel (interpret mode) where it takes the hop,
    else its split path."""
    h_re, h_im = zfft.hermitian_fold_planes(jnp.asarray(zr), jnp.asarray(zi),
                                            wl)
    if wl % step == 0 and wl // step >= 2:
        return np.asarray(zsynth.istft_ola(h_re, h_im, wl, step, SCALE,
                                           interpret=True))
    frames = zfft.direct_real_ifft_folded(h_re, h_im, wl, SCALE)
    return np.asarray(zframe.overlap_add(frames, step))


@pytest.mark.parametrize("wl,step,t,lead", ZAFTPU_CASES)
@pytest.mark.parametrize("layout", ["frames-major", "bins-major"])
def test_fused_fold_plain_matches_zaftpu(wl, step, t, lead, layout,
                                         monkeypatch):
    """float32: within 2e-6 of max of zaftpu's fold and synthesis, on a
    spectrum that is not Hermitian, frames-major or bins-major."""
    monkeypatch.delenv("ZAFTPU_PRECISION", raising=False)
    jax.clear_caches()
    z = _full(lead, wl, t, wl + step + t, layout)
    rows = z.reshape(-1, t, wl)
    ref = np.stack([_zaftpu_ola(r.real.numpy(), r.imag.numpy(), wl, step)
                    for r in rows]).reshape(*lead, -1)
    calls = tirfft.istft_ola_fft_full_plain.calls
    mine = tirfft.istft_ola_fft_full(z, wl, step, SCALE)
    assert tirfft.istft_ola_fft_full_plain.calls == calls + 1
    assert mine.dtype == torch.float32
    assert mine.shape == ref.shape == (*lead, (t - 1) * step + wl)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("wl,step,t,lead", ZAFTPU_CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_fold_plain_is_the_fold_then_the_planes(wl, step, t, lead,
                                                      layout, dtype):
    """Bit-equal to the index fold (core/fft.hermitian_fold_planes)
    followed by the planes' plain version, in every layout and dtype: the
    kernel's order, fold first."""
    z = _full(lead, wl, t, 3 * wl + t, layout, dtype)
    h_re, h_im = tfft.hermitian_fold_planes(z.real, z.imag, wl)
    assert torch.equal(tirfft.istft_ola_fft_full_plain(z, wl, step, SCALE),
                       tirfft.istft_ola_fft_plain(h_re, h_im, wl, step,
                                                  SCALE))


def test_fused_fold_of_a_conjugate_mirror_is_the_half_spectrum():
    """On a Hermitian spectrum (a half spectrum's conjugate mirror) the
    fused fold equals the planes route on the half spectrum itself, bit
    for bit: 0.5 (a + a) = a, and the imaginary parts of DC and Nyquist
    are not read."""
    wl, step, t = 400, 160, 9
    rng = np.random.default_rng(5)
    half = torch.complex(*(torch.from_numpy(rng.standard_normal(
        (t, wl // 2 + 1)).astype(np.float32)) for _ in range(2)))
    full = tfft.conjugate_mirror(half, wl)
    assert torch.equal(
        tirfft.istft_ola_fft_full_plain(full, wl, step, SCALE),
        tirfft.istft_ola_fft_plain(half.real, half.imag, wl, step, SCALE))


# Windows off the static rule: odd (441; 551, 25 ms at 22.05 kHz; 2,205 in
# the 4,096-value block), even by Bluestein (262: P 288; 2,062: P 2,304;
# 4,078: P 4,096, the 4,096-value block) and odd by Bluestein in the
# 8,192-value block (3,093: P 6,400), each with a hop that does not divide
# it.
OFF_RULE = [(441, 147), (551, 220), (2205, 441), (262, 131), (2062, 1031),
            (4078, 1024), (3093, 1000)]


@pytest.mark.parametrize("wl,step", OFF_RULE)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_fold_off_the_rule(wl, step, dtype, monkeypatch):
    """istft at a window rfft.fits refuses reads its full spectrum through
    the fused fold too (irfft_any's load): one call of its plain version,
    within 2e-6 (float32) or 1e-12 (float64) of max of zaftpu.istft of the
    same seeded, non-Hermitian bins-major spectrum, and that plain version
    bit-equal to the index fold followed by the planes' plain version."""
    for name in ("ZAFTPU_PRECISION", "ZAFTPU_FFT", "ZAFTPU_MIRROR",
                 "ZAFTPU_SYNTH"):
        monkeypatch.delenv(name, raising=False)
    assert not trfft.fits(wl)
    t = 6
    rng = np.random.default_rng(wl + step)
    spec = (rng.standard_normal((wl, t))
            + 1j * rng.standard_normal((wl, t))).astype(
                np.complex64 if dtype == np.float32 else np.complex128)
    win = hamming(wl).astype(dtype)
    calls = tirfft.istft_ola_fft_full_plain.calls
    mine = zaftpu_torch.istft(torch.from_numpy(spec), win, step).numpy()
    assert tirfft.istft_ola_fft_full_plain.calls == calls + 1
    ref = np.asarray(zaftpu.istft(spec, win, step))
    assert mine.shape == ref.shape and mine.dtype == dtype
    tol = 2e-6 if dtype == np.float32 else 1e-12
    assert np.abs(mine - ref).max() <= tol * np.abs(ref).max()
    z = torch.from_numpy(spec).T
    h_re, h_im = tfft.hermitian_fold_planes(z.real, z.imag, wl)
    assert torch.equal(tirfft.istft_ola_fft_full_plain(z, wl, step, SCALE),
                       tirfft.istft_ola_fft_plain(h_re, h_im, wl, step,
                                                  SCALE))


def _window_planes_plain(s_re, s_im, n, step, window, wsq):
    """The windowed store's plain version as it read two planes before the
    complex load."""
    frames = tirfft._inverse_frames(s_re, s_im, n, 1.0) * window.to(
        s_re.dtype)
    return tirfft._overlap_add(frames, step) / wsq.to(s_re.dtype)


@pytest.mark.parametrize("wl,step,t,lead", ZAFTPU_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_window_store_complex_plain_is_the_planes_one(wl, step, t, lead,
                                                      dtype):
    """The complex half spectrum's windowed store, bit-equal to the planes
    version it replaces (a view of the same values), and one call."""
    rng = np.random.default_rng(wl * 5 + t)
    s = torch.from_numpy(rng.standard_normal(
        (2, *lead, t, wl // 2 + 1))).to(dtype)
    win = torch.from_numpy(hamming(wl)).to(dtype)
    wsq = torch.from_numpy(np.maximum(np.asarray(zframe.overlap_add(
        jnp.tile(hamming(wl) ** 2, (t, 1)), step)), 1e-12)).to(dtype)
    calls = tirfft.istft_ola_fft_window_plain.calls
    got = tirfft.istft_ola_fft_window(torch.complex(s[0], s[1]), wl, step,
                                      win, wsq)
    assert tirfft.istft_ola_fft_window_plain.calls == calls + 1
    assert torch.equal(got, _window_planes_plain(s[0], s[1], wl, step, win,
                                                 wsq))


def _counts():
    return {"full": tirfft.istft_ola_fft_full_plain.calls,
            "planes": tirfft.istft_ola_fft_plain.calls,
            "fold_kernel": tmirror.fold_half_planes_plain.calls,
            "gemm": tsynth.istft_ola_plain.calls,
            "twin": tsynth.istft_ola_split4_plain.calls}


@pytest.mark.parametrize("wl,env,want", [
    (2048, {}, {"full"}),
    (1102, {}, {"full"}),
    (16, {}, {"full"}),
    (2048, {"ZAFTPU_PRECISION": "split4"}, {"full"}),
    (2048, {"ZAFTPU_FFT": "native"}, {"full"}),
    (2048, {"ZAFTPU_MIRROR": "pallas"}, {"fold_kernel", "planes"}),
    (1102, {"ZAFTPU_MIRROR": "pallas"}, {"fold_kernel", "planes"}),
    (2062, {}, {"full"}),
    (441, {}, {"full"}),
    (2048, {"ZAFTPU_SYNTH": "0"}, set()),
    (2048, {"ZAFTPU_FFT": "matmul"}, {"gemm"}),
    (15, {}, {"gemm"})])
def test_synthesis_route_by_counters(wl, env, want, monkeypatch):
    """istft's synthesis: at every window from 16 to 4,096 (the static
    path, and off it 2,062 by Bluestein and 441 odd) the fused fold, on
    every dial; under ZAFTPU_MIRROR=pallas the fold kernel, then the
    inverse on its planes; ZAFTPU_SYNTH=0 the inverse GEMM and the OLA
    kernel (no synthesis kernel);
    ZAFTPU_FFT=matmul and a window below 16 B4. One call each, and every
    route bit-equal to the index fold followed by the same synthesis."""
    for name in ("ZAFTPU_PRECISION", "ZAFTPU_FFT", "ZAFTPU_MIRROR",
                 "ZAFTPU_SYNTH"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    step = max(wl // 2, 1)
    x = torch.from_numpy(np.random.default_rng(wl).standard_normal(
        12 * wl).astype(np.float32))
    win = hamming(wl, periodic=True).astype(np.float32)
    spec = zaftpu_torch.stft(x, win, step)
    before = _counts()
    rec = zaftpu_torch.istft(spec, win, step)
    moved = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
    assert moved == dict.fromkeys(want, 1)
    monkeypatch.setenv("ZAFTPU_MIRROR", "pallas")
    assert torch.equal(rec, zaftpu_torch.istft(spec, win, step))


def test_griffin_lim_hands_the_complex_spectrum_over(monkeypatch):
    """griffin_lim at a static window passes its complex spectrum to the
    windowed store: each synthesis one call of its plain version, and the
    result bit-equal to the planes version's loop."""
    wl, step, iters = 256, 64, 2
    rng = np.random.default_rng(2)
    mag = torch.from_numpy(np.abs(rng.standard_normal((wl // 2 + 1, 20))))
    win = hamming(wl)
    calls = tirfft.istft_ola_fft_window_plain.calls
    out = zaftpu_torch.griffin_lim(mag, win, step, iterations=iters)
    assert tirfft.istft_ola_fft_window_plain.calls == calls + iters + 1

    def planes(spec, n, step, window, wsq):
        return _window_planes_plain(spec.real, spec.imag, n, step, window,
                                    wsq)

    monkeypatch.setattr(tirfft, "istft_ola_fft_window", planes)
    assert torch.equal(out, zaftpu_torch.griffin_lim(mag, win, step,
                                                     iterations=iters))


def _bad_full_launch(case):
    """Call the fused fold's checking half with one bad argument."""
    wl, step, t = 256, 128, 9
    z = torch.zeros(t, wl, dtype=torch.complex64)
    calls = {
        "c128": lambda: tirfft._launch_complex(
            "istft_ola_fft_full", z.to(torch.complex128), wl, step, 1.0),
        "float32": lambda: tirfft._launch_complex(
            "istft_ola_fft_full", z.real, wl, step, 1.0),
        "off_rule": lambda: tirfft._launch_complex(
            "istft_ola_fft_full", torch.zeros(t, 15, dtype=torch.complex64),
            15, 7, 1.0),
        "odd": lambda: tirfft._launch_complex(
            "istft_ola_fft_full", torch.zeros(2, 4097, dtype=torch.complex64),
            4097, 2048, 1.0),
        "too_long": lambda: tirfft._launch_complex(
            "istft_ola_fft_full", torch.zeros(2, 8192, dtype=torch.complex64),
            8192, 4096, 1.0),
        "step_0": lambda: tirfft._launch_complex("istft_ola_fft_full", z, wl,
                                                 0, 1.0),
        "step_past_n": lambda: tirfft._launch_complex(
            "istft_ola_fft_full", z, wl, wl + 1, 1.0),
        "width": lambda: tirfft._launch_complex("istft_ola_fft_full",
                                                z[:, :-1], wl, step, 1.0),
        "half_width": lambda: tirfft._launch_complex(
            "istft_ola_fft_full", z[:, :wl // 2 + 1], wl, step, 1.0),
        "no_frames_axis": lambda: tirfft._launch_complex(
            "istft_ola_fft_full", z[0], wl, step, 1.0),
    }
    return calls[case]()


@pytest.mark.parametrize("case", ["c128", "float32", "off_rule", "odd",
                                  "too_long", "step_0", "step_past_n",
                                  "width", "half_width", "no_frames_axis"])
def test_fused_fold_refuses_before_launch(case, monkeypatch):
    """The fused fold's CUDA half checks the dtype (complex64 only:
    NotImplementedError), the window (16 to 4,096: 15 and the odd 4,097
    are refused), the hop and the spectrum's width and axes (ValueError)
    before it touches the library; no launch is counted."""
    def no_library():
        raise AssertionError("the launch was reached")

    monkeypatch.setattr(_build, "library", no_library)
    launches = tirfft.istft_ola_fft_full.launches
    error = (NotImplementedError if case in ("c128", "float32")
             else ValueError)
    with pytest.raises(error):
        _bad_full_launch(case)
    assert tirfft.istft_ola_fft_full.launches == launches


@pytest.mark.parametrize("wl,step,t,batch", [
    (2048, 1024, 25841, 1), (2048, 512, 51681, 1), (1764, 882, 30001, 1),
    (1102, 551, 48023, 1), (1200, 300, 48001, 1), (2032, 1000, 301, 3),
    (4096, 256, 1001, 1), (400, 160, 1001, 3), (16, 1, 700, 2),
    (4096, 4096, 1, 1), (2062, 1031, 25841, 1), (441, 147, 180001, 1),
    (4078, 1024, 25842, 1)])
def test_block_span_by_waves(wl, step, t, batch):
    """block_span (csrc/stockham.cuh: span_for): a multiple of the hop within
    SPAN whose waves of blocks times groups a block is the least of every
    multiple's, with the frames a group and the blocks an SM of geometry:
    on the 600-s WL 2048 / hop 1024 signal 7 hops (8 frames, 4 groups of
    2, the fewest groups an output frame), on a short one shorter blocks
    than that rule would give; off the static rule (irfft_any) the rows of
    its block (4 of 441 values in 2,048, 1 of 2,304 at 2,062 and of 4,096
    at 4,078) and the blocks its shared memory leaves an SM (3, 3, 2)."""
    span = tirfft.block_span(wl, step, t, batch)
    assert span % step == 0 and step <= span <= tirfft.SPAN
    fpb, per_sm = tirfft.geometry(wl)
    if trfft.fits(wl):
        assert (fpb, per_sm) == (2048 // (wl // 2), tirfft.BLOCKS_PER_SM)
    else:
        assert (fpb, per_sm) == {2062: (1, 3), 441: (4, 3),
                                 4078: (1, 2)}[wl]
    out_len = (t - 1) * step + wl
    slots = 132 * per_sm

    def cost(m):
        blocks = -(-out_len // (m * step)) * batch
        return -(-blocks // slots) * -(-(m + (wl - 1) // step) // fpb)

    assert cost(span // step) == min(cost(m) for m in
                                     range(1, tirfft.SPAN // step + 1))
    if (wl, step, t) == (2048, 1024, 25841):
        assert span == 7 * 1024
    if (wl, step, t) == (2032, 1000, 301):
        assert span < 8 * 1000  # the fewest groups an output frame: 8 hops
