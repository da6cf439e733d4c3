"""Each zaftpu_torch kernel's plain version against the zaftpu Pallas kernel
it replaces (interpret mode), on the same numpy inputs and operators.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py compare them with these plain versions there). Here the
wrappers take their plain versions because the tensors lie on the CPU.
Shapes: WL 256 / hop 128 (K = 2) and WL 512 / hop 128 (K = 4), with T not a
multiple of 8; the MDCT synthesis at F = 128, 256 and the ragged 100.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zaftpu.core.windows import hamming
from zaftpu.features import mel as zmel
from zaftpu.pallas import framing as zframing
from zaftpu.pallas import fused as zfused
from zaftpu.pallas import melfused as zmelfused
from zaftpu.pallas import ola as zola
from zaftpu.pallas import synth as zsynth
from zaftpu.transforms import mdct as zmdct
from zaftpu_torch import kernels as tkernels
from zaftpu_torch.core import fft as tfft
from zaftpu_torch.kernels import framing as tframing
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import irfft as tirfft
from zaftpu_torch.kernels import mdct as tkmdct
from zaftpu_torch.kernels import melfused as tmelfused
from zaftpu_torch.kernels import ola as tola
from zaftpu_torch.kernels import rfft as trfft
from zaftpu_torch.kernels import synth as tsynth
from zaftpu_torch.transforms import mdct as tmdct

SHAPES = [(256, 128, 37), (512, 128, 61), (512, 128, 5)]


def _signal(wl, step, t, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(t * step + wl - step).astype(np.float32)


def _exact_close(mine, ref):
    np.testing.assert_allclose(mine, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


def _gemm_close(mine, ref, oracle=None):
    """Float32 GEMMs of one contraction in two summation orders: within
    2e-6 of max (and of each value). The worst case on these shapes sits at
    a third of that limit. On failure the message gives the worst ratio to
    the limit, the rows past it and, with a float64 ``oracle``, each side's
    worst ratio against it, which names the side at fault."""
    limit = 2e-6 * np.abs(ref) + 2e-6 * np.abs(ref).max()
    ratio = np.abs(mine - ref) / limit
    rows = sorted(set(np.nonzero(ratio > 1)[0].tolist()))
    msg = f"worst |mine - ref| / limit {ratio.max():.3g}, rows {rows[:40]}"
    if oracle is not None:
        msg += (f"; vs the float64 oracle: mine "
                f"{(np.abs(mine - oracle) / limit).max():.3g}, zaftpu "
                f"{(np.abs(ref - oracle) / limit).max():.3g}")
    np.testing.assert_allclose(mine, ref, rtol=2e-6,
                               atol=2e-6 * np.abs(ref).max(), err_msg=msg)


@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_framing_matches_zaftpu(wl, step, t):
    padded = _signal(wl, step, t, 1)
    win = hamming(wl).astype(np.float32)
    ref = np.asarray(zframing.frame_window(
        jnp.asarray(padded), jnp.asarray(win), wl, step, t, interpret=True))
    mine = tframing.frame_window(torch.from_numpy(padded),
                                 torch.from_numpy(win), wl, step, t)
    assert mine.shape == ref.shape and mine.dtype == torch.float32
    _exact_close(mine.numpy(), ref)


@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_ola_matches_zaftpu(wl, step, t):
    frames = np.random.default_rng(2).standard_normal((t, wl)).astype(
        np.float32)
    ref = np.asarray(zola.overlap_add(jnp.asarray(frames), step,
                                      interpret=True))
    mine = tola.overlap_add(torch.from_numpy(frames), step)
    assert mine.shape == ref.shape and mine.dtype == torch.float32
    _exact_close(mine.numpy(), ref)


@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_fused_matches_zaftpu(wl, step, t):
    padded = _signal(wl, step, t, 3)
    win = hamming(wl).astype(np.float32)
    ref = np.asarray(zfused.frames_rfft(
        jnp.asarray(padded), jnp.asarray(win), wl, step, t, interpret=True))
    ops = tfft.operators_from_numpy(zfused._rdft_ops_padded(wl), wl, "rdft")
    mine = tfused.frames_rfft(torch.from_numpy(padded), torch.from_numpy(win),
                              wl, step, t, ops=ops)
    assert mine.shape == ref.shape and mine.dtype == torch.complex64
    _gemm_close(mine.numpy().real, ref.real)
    _gemm_close(mine.numpy().imag, ref.imag)


@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_synth_matches_zaftpu(wl, step, t, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    rng = np.random.default_rng(4)
    f = wl // 2 + 1
    h_re, h_im = rng.standard_normal((2, t, f)).astype(np.float32)
    scale = 0.7310586
    ref = np.asarray(zsynth.istft_ola(jnp.asarray(h_re), jnp.asarray(h_im),
                                      wl, step, scale, interpret=True))
    ops = tfft.operators_from_numpy(zsynth._istft_ops_padded(wl, scale), wl,
                                    "istft")
    mine = tsynth.istft_ola(torch.from_numpy(h_re), torch.from_numpy(h_im),
                            wl, step, scale, ops=ops)
    assert mine.shape == ref.shape and mine.dtype == torch.float32
    _gemm_close(mine.numpy(), ref)


@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_synth_own_operator_matches_zaftpu_split_path(wl, step, t,
                                                      monkeypatch):
    """Without an operator override the plain synthesis builds its own,
    and agrees with zaftpu's split GEMM-then-OLA programs."""
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    from zaftpu.core import fft as zfft
    from zaftpu.core import frame as zframe

    rng = np.random.default_rng(5)
    f = wl // 2 + 1
    h_re, h_im = rng.standard_normal((2, t, f)).astype(np.float32)
    frames = zfft.direct_real_ifft_folded(jnp.asarray(h_re),
                                          jnp.asarray(h_im), wl, 0.5)
    ref = np.asarray(zframe.overlap_add(frames, step))
    mine = tsynth.istft_ola(torch.from_numpy(h_re), torch.from_numpy(h_im),
                            wl, step, 0.5)
    _gemm_close(mine.numpy(), ref)


def _counts():
    return (tframing.frame_window.launches, tola.overlap_add.launches,
            tfused.frames_rfft.launches, tsynth.istft_ola.launches,
            trfft.frames_rfft_fft.launches, tirfft.istft_ola_fft.launches)


def test_cpu_tensors_take_plain_versions_only():
    """WL 256 takes the FFT kernel's plain version, WL 255 given its
    operator the GEMM's; the synthesis, given its operator, B4's."""
    wl, step, t = 256, 128, 9
    padded = torch.from_numpy(_signal(wl, step, t, 6))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    launches = _counts()

    def calls():
        return (tframing.frame_window_plain.calls,
                tola.overlap_add_plain.calls, tfused.frames_rfft_plain.calls,
                tsynth.istft_ola_plain.calls,
                trfft.frames_rfft_fft_plain.calls)

    before = calls()
    frames = tframing.frame_window(padded, win, wl, step, t)
    tola.overlap_add(frames, step)
    half = tfused.frames_rfft(padded, win, wl, step, t)
    tsynth.istft_ola(half.real.contiguous(), half.imag.contiguous(), wl, step,
                     1.0, ops=tsynth.istft_ops(wl, 1.0, torch.float32, "cpu"))
    tfused.frames_rfft(padded[:-1], win[:-1], wl - 1, step, t,
                       ops=tfused.rdft_ops(wl - 1, torch.float32, "cpu"))
    assert _counts() == launches
    assert calls() == tuple(c + 1 for c in before)


def _bad_launch(case):
    """Call a CUDA wrapper's checking half with one bad argument."""
    wl, step, t = 256, 128, 9
    padded = torch.zeros(t * step + wl - step)
    win = torch.zeros(wl)
    h = torch.zeros(t, wl // 2 + 1)
    calls = {
        "fused_f64": lambda: tfused._frames_rfft_cuda(
            padded.double(), win, wl, step, t),
        "fused_step": lambda: tfused._frames_rfft_cuda(
            padded, win, wl, wl + 1, t),
        "fused_window": lambda: tfused._frames_rfft_cuda(
            padded, win[:-1], wl, step, t),
        "fused_short": lambda: tfused._frames_rfft_cuda(
            padded[:-1], win, wl, step, t),
        "fused_ops": lambda: tfused._frames_rfft_cuda(
            padded, win, wl, step, t,
            ops=tfused.rdft_ops(wl, torch.float32, "cpu")[:, :, :-64]),
        "synth_f64": lambda: tsynth._istft_ola_cuda(
            h.double(), h.double(), wl, step, 1.0),
        "synth_planes": lambda: tsynth._istft_ola_cuda(
            h, h[:-1], wl, step, 1.0),
        "synth_width": lambda: tsynth._istft_ola_cuda(
            h[:, :-1], h[:, :-1], wl, step, 1.0),
        "synth_step": lambda: tsynth._istft_ola_cuda(h, h, wl, 0, 1.0),
        "synth_ops": lambda: tsynth._istft_ola_cuda(
            h, h, wl, step, 1.0,
            ops=tsynth.istft_ops(wl, 1.0, torch.float64, "cpu")),
        "framing_f64": lambda: tframing._frame_window_cuda(
            padded.double(), win, wl, step, t),
        "framing_step": lambda: tframing._frame_window_cuda(
            padded, win, wl, 0, t),
        "framing_short": lambda: tframing._frame_window_cuda(
            padded[:-1], win, wl, step, t),
        "ola_f64": lambda: tola._overlap_add_cuda(
            torch.zeros(t, wl, dtype=torch.float64), step),
        "ola_step": lambda: tola._overlap_add_cuda(torch.zeros(t, wl),
                                                   wl + 1),
    }
    return calls[case]()


@pytest.mark.parametrize("case", [
    "fused_f64", "fused_step", "fused_window", "fused_short", "fused_ops",
    "synth_f64", "synth_planes", "synth_width", "synth_step", "synth_ops",
    "framing_f64", "framing_step", "framing_short", "ola_f64", "ola_step"])
def test_cuda_wrappers_refuse_before_launch(case, monkeypatch):
    """Each CUDA wrapper checks dtype, shapes, hop and operator before it
    touches the library: non-float32 raises NotImplementedError, the rest
    ValueError, and nothing is launched or counted."""
    from zaftpu_torch.kernels import _build

    def no_library():
        raise AssertionError("the launch was reached")

    monkeypatch.setattr(_build, "library", no_library)
    launches = _counts()
    error = NotImplementedError if case.endswith("_f64") else ValueError
    with pytest.raises(error):
        _bad_launch(case)
    assert _counts() == launches


@pytest.mark.parametrize("wl,step,t", [(256, 128, 9), (512, 128, 11),
                                       (64, 24, 10)])
def test_batched_equals_per_item(wl, step, t):
    rng = np.random.default_rng(8)
    padded = torch.from_numpy(rng.standard_normal(
        (2, 3, t * step + wl - step)).astype(np.float32))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    half = tfused.frames_rfft(padded, win, wl, step, t)
    frames = tframing.frame_window(padded, win, wl, step, t)
    ola = tola.overlap_add(frames, step)
    synth = tsynth.istft_ola(half.real, half.imag, wl, step, 0.5)
    for i in range(2):
        for j in range(3):
            one = padded[i, j]
            torch.testing.assert_close(
                half[i, j], tfused.frames_rfft(one, win, wl, step, t))
            torch.testing.assert_close(
                frames[i, j], tframing.frame_window(one, win, wl, step, t))
            torch.testing.assert_close(
                ola[i, j], tola.overlap_add(frames[i, j], step))
            torch.testing.assert_close(
                synth[i, j], tsynth.istft_ola(half[i, j].real,
                                              half[i, j].imag, wl, step, 0.5))


@pytest.mark.parametrize("lever,value", [("ZAFTPU_FUSED", "0"),
                                         ("ZAFTPU_SYNTH", "0")])
def test_split_levers_agree_with_fused(lever, value, monkeypatch):
    wl, step, t = 512, 128, 21
    padded = torch.from_numpy(_signal(wl, step, t, 9))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    half = tkernels.windowed_frames_rfft(padded, win, wl, step, t)
    spec = tfft.full_from_half(half, wl).transpose(-1, -2)
    sig = tkernels.synthesis_ola(spec, step, 1.5)
    before = (tframing.frame_window_plain.calls, tola.overlap_add_plain.calls)
    monkeypatch.setenv(lever, value)
    half2 = tkernels.windowed_frames_rfft(padded, win, wl, step, t)
    sig2 = tkernels.synthesis_ola(spec, step, 1.5)
    after = (tframing.frame_window_plain.calls, tola.overlap_add_plain.calls)
    moved = 0 if lever == "ZAFTPU_FUSED" else 1
    assert after[moved] == before[moved] + 1
    assert after[1 - moved] == before[1 - moved]
    _gemm_close(half2.numpy().real, half.numpy().real)
    _gemm_close(half2.numpy().imag, half.numpy().imag)
    _gemm_close(sig2.numpy(), sig.numpy())



@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_frames_op_matches_zaftpu(wl, step, t):
    padded = _signal(wl, step, t, 10)
    win = np.sin(np.pi * (np.arange(wl) + 0.5) / wl).astype(np.float32)
    ref = np.asarray(zfused.frames_op(
        jnp.asarray(padded), jnp.asarray(win),
        zmdct._direct_forward_ops_padded, wl // 2, wl, step, t,
        interpret=True))
    ops = tfft.operators_from_numpy(zmdct._direct_forward_ops_padded(wl),
                                    wl, "mdct")
    mine = tfused.frames_op(torch.from_numpy(padded), torch.from_numpy(win),
                            ops, wl // 2, wl, step, t)
    assert mine.shape == ref.shape and mine.dtype == torch.float32
    _gemm_close(mine.numpy(), ref)


@pytest.mark.parametrize("f,t", [(128, 37), (256, 61), (100, 9)])
def test_imdct_ola_matches_zaftpu(f, t, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    coeffs = np.random.default_rng(11).standard_normal((t, f)).astype(
        np.float32)
    wbytes = np.sin(np.pi * (np.arange(2 * f) + 0.5) / (2 * f)).tobytes()
    ref = np.asarray(zsynth.imdct_ola(jnp.asarray(coeffs), f, wbytes,
                                      interpret=True))
    ops = tfft.operators_from_numpy(zsynth._imdct_ops_padded(f, wbytes),
                                    2 * f, "imdct")
    mine = tsynth.imdct_ola(torch.from_numpy(coeffs), f, wbytes, ops=ops)
    assert mine.shape == ref.shape == (t * f + f,)
    assert mine.dtype == torch.float32
    _gemm_close(mine.numpy(), ref)
    # Its own operator (built from the port's host math) agrees too.
    _gemm_close(tsynth.imdct_ola(torch.from_numpy(coeffs), f,
                                 wbytes).numpy(), ref)


@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_spec_rows_matches_zaftpu(wl, step, t, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    padded = _signal(wl, step, t, 12)
    win = hamming(wl).astype(np.float32)
    ref = np.asarray(zmelfused.spec_rows(
        jnp.asarray(padded), jnp.asarray(win), wl, step, t, interpret=True))
    ops = tfft.operators_from_numpy(zfused._rdft_ops_padded(wl), wl, "spec")
    mine = tmelfused.spec_rows(torch.from_numpy(padded),
                               torch.from_numpy(win), wl, step, t, ops=ops)
    assert mine.shape == ref.shape == (t, wl // 2)
    assert mine.dtype == torch.float32
    frames = np.lib.stride_tricks.sliding_window_view(
        padded.astype(np.float64), wl)[::step][:t] * win
    oracle = np.abs(np.fft.rfft(frames, axis=-1))[:, 1:]
    _gemm_close(mine.numpy(), ref, oracle)


@pytest.mark.parametrize("lowered", ["high", "medium", "mkldnn bf16",
                                     "mkldnn tf32"])
def test_exact_matmul_refuses_a_lowered_precision_on_cpu(lowered):
    """A lowered float32 matmul precision (oneDNN's bf16 or TF32 products on
    the CPU) raises in the exact path instead of returning numbers that are
    off by far more than float32 rounding; float64 is unaffected."""
    wl, step, t = 256, 128, 9
    padded = torch.from_numpy(_signal(wl, step, t, 12))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    mkldnn = torch.backends.mkldnn.matmul
    try:
        if lowered.startswith("mkldnn"):
            mkldnn.fp32_precision = lowered.split()[1]
        else:
            torch.set_float32_matmul_precision(lowered)
        with pytest.raises(RuntimeError, match="precision is lowered"):
            tmelfused.spec_rows(padded, win, wl, step, t)
        tmelfused.spec_rows(padded.double(), win.double(), wl, step, t)
    finally:  # back to torch's start state: highest, oneDNN's "none"
        torch.set_float32_matmul_precision("highest")
        mkldnn.fp32_precision = "none"
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.equal(tmelfused.spec_rows(padded, win, wl, step, t),
                       tmelfused.spec_rows_plain(padded, win, wl, step, t))


@pytest.mark.parametrize("power", [False, True])
@pytest.mark.parametrize("wl,step,t,sr,mels", [(256, 128, 37, 8000, 20),
                                               (512, 128, 61, 16000, 40),
                                               (512, 128, 5, 22050, 7)])
def test_mel_rows_matches_zaftpu(wl, step, t, sr, mels, power, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    padded = _signal(wl, step, t, 13)
    win = hamming(wl).astype(np.float32)
    fbank_t = np.ascontiguousarray(
        zmel.melfilterbank(sr, wl, mels).T.astype(np.float32))
    ref = np.asarray(zmelfused.mel_rows(
        jnp.asarray(padded), jnp.asarray(win), jnp.asarray(fbank_t), wl,
        step, t, power, interpret=True))
    ops = tfft.operators_from_numpy(zfused._rdft_ops_padded(wl), wl, "spec")
    mine = tmelfused.mel_rows(torch.from_numpy(padded),
                              torch.from_numpy(win),
                              torch.from_numpy(fbank_t), wl, step, t, power,
                              ops=ops)
    assert mine.shape == ref.shape == (t, mels)
    assert mine.dtype == torch.float32
    _gemm_close(mine.numpy(), ref)


def _new_counts():
    return (tfused.frames_op.launches, tsynth.imdct_ola.launches,
            tmelfused.spec_rows.launches, tmelfused.mel_rows.launches)


def _new_calls():
    return (tfused.frames_op_plain.calls, tsynth.imdct_ola_plain.calls,
            tmelfused.spec_rows_plain.calls, tmelfused.mel_rows_plain.calls)


def test_new_wrappers_take_plain_versions_on_cpu():
    wl, step, t = 256, 128, 9
    padded = torch.from_numpy(_signal(wl, step, t, 14))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    ops = tfft.operators_from_numpy(zmdct._direct_forward_ops_padded(wl),
                                    wl, "mdct")
    launches, calls = _new_counts(), _new_calls()
    coeffs = tfused.frames_op(padded, win, ops, wl // 2, wl, step, t)
    wb = np.ones(wl).tobytes()
    # An explicit operator names the GEMM at a window the MDCT rule takes.
    tsynth.imdct_ola(coeffs, wl // 2, wb,
                     ops=tsynth.imdct_ops(wl // 2, wb, torch.float32, "cpu"))
    tmelfused.spec_rows(padded, win, wl, step, t)
    tmelfused.mel_rows(padded, win, torch.ones(wl // 2, 3), wl, step, t,
                       False)
    assert _new_counts() == launches
    assert _new_calls() == tuple(c + 1 for c in calls)


def _bad_new_launch(case):
    """Call a new CUDA wrapper's checking half with one bad argument."""
    wl, step, t = 256, 128, 9
    padded = torch.zeros(t * step + wl - step)
    win = torch.zeros(wl)
    mops = torch.zeros(1, wl, 128)
    coeffs = torch.zeros(t, wl // 2)
    wb = np.ones(wl).tobytes()
    fbt = torch.zeros(wl // 2, 40)
    calls = {
        "frames_op_f64": lambda: tfused._frames_op_cuda(
            padded.double(), win, mops, wl // 2, wl, step, t),
        "frames_op_step": lambda: tfused._frames_op_cuda(
            padded, win, mops, wl // 2, wl, wl + 1, t),
        "frames_op_short": lambda: tfused._frames_op_cuda(
            padded[:-1], win, mops, wl // 2, wl, step, t),
        "frames_op_ops": lambda: tfused._frames_op_cuda(
            padded, win, mops[:, :, :64], wl // 2, wl, step, t),
        "imdct_f64": lambda: tsynth._imdct_ola_cuda(
            coeffs.double(), wl // 2, wb),
        "imdct_width": lambda: tsynth._imdct_ola_cuda(
            coeffs[:, :-1], wl // 2, wb),
        "imdct_ops": lambda: tsynth._imdct_ola_cuda(
            coeffs, wl // 2, wb, ops=torch.zeros(wl // 2, wl - 2)),
        "spec_f64": lambda: tmelfused._spec_rows_cuda(
            padded.double(), win, wl, step, t),
        "spec_window": lambda: tmelfused._spec_rows_cuda(
            padded, win[:-1], wl, step, t),
        "spec_ops": lambda: tmelfused._spec_rows_cuda(
            padded, win, wl, step, t, ops=torch.zeros(2, wl, 64)),
        "mel_f64": lambda: tmelfused._mel_rows_cuda(
            padded.double(), win, fbt, wl, step, t, False),
        "mel_fbank_f64": lambda: tmelfused._mel_rows_cuda(
            padded, win, fbt.double(), wl, step, t, False),
        "mel_fbank_rows": lambda: tmelfused._mel_rows_cuda(
            padded, win, fbt[:-1], wl, step, t, False),
        "mel_no_mels": lambda: tmelfused._mel_rows_cuda(
            padded, win, torch.zeros(wl // 2, 0), wl, step, t, True),
        "mel_short": lambda: tmelfused._mel_rows_cuda(
            padded[:-1], win, fbt, wl, step, t, True),
    }
    return calls[case]()


@pytest.mark.parametrize("case", [
    "frames_op_f64", "frames_op_step", "frames_op_short", "frames_op_ops",
    "imdct_f64", "imdct_width", "imdct_ops", "spec_f64", "spec_window",
    "spec_ops", "mel_f64", "mel_fbank_f64", "mel_fbank_rows", "mel_no_mels",
    "mel_short"])
def test_new_cuda_wrappers_refuse_before_launch(case, monkeypatch):
    """The MDCT and magnitude wrappers check dtype, shapes, hop, operator
    and filterbank before they touch the library: non-float32 raises
    NotImplementedError, the rest ValueError; nothing is launched."""
    from zaftpu_torch.kernels import _build

    def no_library():
        raise AssertionError("the launch was reached")

    monkeypatch.setattr(_build, "library", no_library)
    launches = _new_counts()
    error = NotImplementedError if case.endswith("_f64") else ValueError
    with pytest.raises(error):
        _bad_new_launch(case)
    assert _new_counts() == launches


@pytest.mark.parametrize("wl,step,t", [(256, 128, 9), (512, 256, 11),
                                       (64, 24, 10)])
def test_new_wrappers_batched_equal_per_item(wl, step, t):
    rng = np.random.default_rng(15)
    padded = torch.from_numpy(rng.standard_normal(
        (2, 3, t * step + wl - step)).astype(np.float32))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    ops = torch.from_numpy(tmdct._direct_forward_ops_padded(wl))
    fbt = torch.from_numpy(rng.random((wl // 2, 5)).astype(np.float32))
    wb = hamming(wl).tobytes()
    op = tfused.frames_op(padded, win, ops, wl // 2, wl, step, t)
    syn = tsynth.imdct_ola(op, wl // 2, wb)
    spec = tmelfused.spec_rows(padded, win, wl, step, t)
    mel = tmelfused.mel_rows(padded, win, fbt, wl, step, t, True)
    for i in range(2):
        for j in range(3):
            one = padded[i, j]
            torch.testing.assert_close(
                op[i, j], tfused.frames_op(one, win, ops, wl // 2, wl, step,
                                           t))
            torch.testing.assert_close(
                syn[i, j], tsynth.imdct_ola(op[i, j], wl // 2, wb))
            torch.testing.assert_close(
                spec[i, j], tmelfused.spec_rows(one, win, wl, step, t))
            torch.testing.assert_close(
                mel[i, j], tmelfused.mel_rows(one, win, fbt, wl, step, t,
                                              True))


@pytest.mark.parametrize("lever,deltas", [
    ("ZAFTPU_FUSED", (1, 0, 0, 0, 0, 1)), ("ZAFTPU_SYNTH", (0, 1, 0, 0, 1, 0))])
def test_mdct_split_levers_agree_with_fused(lever, deltas, monkeypatch):
    """Each lever moves its half of the MDCT path from the fast MDCT (IMDCT)
    kernel, which WL 512 takes by the shape rule, to the framing or OLA
    kernel's plain version and a GEMM, and the values agree with the fused
    ones."""
    wl, step, t = 512, 256, 21
    x = torch.from_numpy(_signal(wl, step, t, 16))
    win = hamming(wl)
    wb = win.tobytes()
    coeffs = tmdct.mdct(x, win).transpose(-1, -2)
    sig = tkernels.imdct_synthesis(coeffs, step, wb)

    def calls():
        return (tframing.frame_window_plain.calls,
                tola.overlap_add_plain.calls, tfused.frames_op_plain.calls,
                tsynth.imdct_ola_plain.calls, tkmdct.mdct_fft_plain.calls,
                tkmdct.imdct_ola_fft_plain.calls)

    before = calls()
    monkeypatch.setenv(lever, "0")
    coeffs2 = tmdct.mdct(x, win).transpose(-1, -2)
    sig2 = tkernels.imdct_synthesis(coeffs, step, wb)
    assert calls() == tuple(b + d for b, d in zip(before, deltas))
    _gemm_close(coeffs2.numpy(), coeffs.numpy())
    _gemm_close(sig2.numpy(), sig.numpy())


# B10, B11a, B11b and B3: the CQT slab kernel, the mirror and fold kernels
# and the full-spectrum analysis kernel.

from zaftpu.pallas import cqtslab as zcqtslab  # noqa: E402
from zaftpu.pallas import mirror as zmirror  # noqa: E402
from zaftpu.transforms import cqt as zcqt  # noqa: E402
from zaftpu_torch.kernels import cqtslab as tcqtslab  # noqa: E402
from zaftpu_torch.kernels import mirror as tmirror  # noqa: E402


def _cqt_case(sr, bins, fmin, fmax, seconds, seed):
    """A padded signal as ``cqtspectrogram`` pads it and the operator, for
    zaftpu's kernel at these parameters (the port's is bit-equal,
    tests/test_torch_cqt.py)."""
    kern = zcqt.cqtkernel(sr, bins, fmin, fmax)
    step = round(sr / 25)
    n = int(sr * seconds)
    t = n // step
    length = kern.fft_length
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    pad_front = -(-(length - step) // 2)
    padded = np.pad(x, (pad_front, length))
    return kern, padded, step, t


@pytest.mark.parametrize("sr,bins,fmin,fmax,seconds", [
    (8000, 12, 110.0, 880.0, 2), (8000, 12, 220.0, 880.0, 1.3)])
def test_cqt_magnitudes_matches_zaftpu(sr, bins, fmin, fmax, seconds):
    """B10's plain version against the Pallas slab kernel in interpret
    mode at tests/test_pallas.py's geometry (L 2048, hop 320, F 36) and a
    narrower one (F 24, a T that is not a multiple of the block)."""
    kern, padded, step, t = _cqt_case(sr, bins, fmin, fmax, seconds, 17)
    length, f = kern.fft_length, kern.number_frequencies
    m_real = np.ascontiguousarray(kern.time_kernel.real.T).astype(np.float32)
    m_imag = np.ascontiguousarray(kern.time_kernel.imag.T).astype(np.float32)
    key = ("test_torch_cqt_magnitudes", sr, bins, fmin, fmax)
    zcqtslab.register_kernel(key, m_real, m_imag)
    ref = np.asarray(zcqtslab.cqt_magnitudes(
        jnp.asarray(padded), key, step, length, t, f, block=16,
        interpret=True))
    ops = torch.from_numpy(tcqtslab.time_ops(kern.time_kernel))
    assert ops.shape == (2, length, tfused.padded_cols(f))
    mine = tcqtslab.cqt_magnitudes(torch.from_numpy(padded), ops, step,
                                   length, t, f)
    assert mine.shape == ref.shape == (t, f) and mine.dtype == torch.float32
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


def test_cqt_time_ops_match_zaftpu_planes():
    kern = zcqt.cqtkernel(8000, 12, 110.0, 880.0)
    ops = tcqtslab.time_ops(kern.time_kernel)
    f = kern.number_frequencies
    np.testing.assert_array_equal(
        ops[0, :, :f], np.ascontiguousarray(kern.time_kernel.real.T).astype(
            np.float32))
    np.testing.assert_array_equal(
        ops[1, :, :f], np.ascontiguousarray(kern.time_kernel.imag.T).astype(
            np.float32))
    assert not ops[:, :, f:].any()


@pytest.mark.parametrize("strategy", ["rev", "dot"])
@pytest.mark.parametrize("n,t", [(256, 37), (512, 61), (256, 5)])
def test_mirror_and_fold_match_zaftpu_bitwise(n, t, strategy):
    rng = np.random.default_rng(n + t)
    re, im = rng.standard_normal((2, t, n // 2 + 1)).astype(np.float32)
    ref_re, ref_im = zmirror.mirror_full_planes(
        jnp.asarray(re), jnp.asarray(im), n, strategy=strategy,
        interpret=True)
    full = tmirror.mirror_full_planes(
        torch.complex(torch.from_numpy(re), torch.from_numpy(im)), n)
    assert full.shape == (t, n) and full.dtype == torch.complex64
    np.testing.assert_array_equal(full.real.numpy(), np.asarray(ref_re))
    np.testing.assert_array_equal(full.imag.numpy(), np.asarray(ref_im))
    zr, zi = rng.standard_normal((2, t, n)).astype(np.float32)
    ref_hr, ref_hi = zmirror.fold_half_planes(
        jnp.asarray(zr), jnp.asarray(zi), n, strategy=strategy,
        interpret=True)
    h_re, h_im = tmirror.fold_half_planes(
        torch.complex(torch.from_numpy(zr), torch.from_numpy(zi)), n)
    assert h_re.shape == h_im.shape == (t, n // 2 + 1)
    np.testing.assert_array_equal(h_re.numpy(), np.asarray(ref_hr))
    np.testing.assert_array_equal(h_im.numpy(), np.asarray(ref_hi))


@pytest.mark.parametrize("wl,step,t", SHAPES)
def test_frames_rfft_full_matches_zaftpu(wl, step, t):
    padded = _signal(wl, step, t, 18)
    win = hamming(wl).astype(np.float32)
    ref_re, ref_im = zfused.frames_rfft_full(
        jnp.asarray(padded), jnp.asarray(win), wl, step, t, interpret=True)
    ops = tfft.operators_from_numpy(zfused._rdft_ops_padded(wl), wl, "rdft")
    mine = tfused.frames_rfft_full(torch.from_numpy(padded),
                                   torch.from_numpy(win), wl, step, t,
                                   ops=ops)
    assert mine.shape == (t, wl) and mine.dtype == torch.complex64
    _gemm_close(mine.numpy().real, np.asarray(ref_re))
    _gemm_close(mine.numpy().imag, np.asarray(ref_im))
    # Bit-equal to the half spectrum followed by the conjugate mirror.
    half = tfused.frames_rfft(torch.from_numpy(padded), torch.from_numpy(win),
                              wl, step, t, ops=ops)
    assert torch.equal(mine, tfft.conjugate_mirror(half, wl))


def _b3_b11_counts():
    return (tcqtslab.cqt_magnitudes.launches,
            tmirror.mirror_full_planes.launches,
            tmirror.fold_half_planes.launches,
            tfused.frames_rfft_full.launches)


def _b3_b11_calls():
    return (tcqtslab.cqt_magnitudes_plain.calls,
            tmirror.mirror_full_planes_plain.calls,
            tmirror.fold_half_planes_plain.calls,
            tfused.frames_rfft_full_plain.calls)


def test_cqt_mirror_full_wrappers_take_plain_versions_on_cpu():
    wl, step, t = 256, 128, 9
    padded = torch.from_numpy(_signal(wl, step, t, 19))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    kern = zcqt.cqtkernel(8000, 12, 110.0, 880.0)
    ops = torch.from_numpy(tcqtslab.time_ops(kern.time_kernel))
    sig = torch.zeros(20 * 320 + kern.fft_length)
    launches, calls = _b3_b11_counts(), _b3_b11_calls()
    tcqtslab.cqt_magnitudes(sig, ops, 320, kern.fft_length, 20,
                            kern.number_frequencies)
    # B3 is the GEMM's full store: an explicit operator names it at WL 256.
    full = tfused.frames_rfft_full(padded, win, wl, step, t,
                                   ops=tfused.rdft_ops(wl, torch.float32,
                                                       "cpu"))
    tmirror.mirror_full_planes(tfused.frames_rfft(padded, win, wl, step, t),
                               wl)
    tmirror.fold_half_planes(full, wl)
    assert _b3_b11_counts() == launches
    assert _b3_b11_calls() == tuple(c + 1 for c in calls)


def _bad_b3_b11_launch(case):
    """Call a B3, B10 or B11 CUDA wrapper's checking half with one bad
    argument."""
    wl, step, t = 256, 128, 9
    padded = torch.zeros(t * step + wl - step)
    win = torch.zeros(wl)
    length, f = 2048, 36
    ops = torch.zeros(2, length, 64)
    sig = torch.zeros((t - 1) * 320 + length)
    half = torch.zeros(t, wl // 2 + 1, dtype=torch.complex64)
    full = torch.zeros(t, wl, dtype=torch.complex64)
    calls = {
        "cqt_f64": lambda: tcqtslab._cqt_magnitudes_cuda(
            sig.double(), ops, 320, length, t, f),
        "cqt_ops": lambda: tcqtslab._cqt_magnitudes_cuda(
            sig, ops[:, :-1], 320, length, t, f),
        "cqt_ops_dtype": lambda: tcqtslab._cqt_magnitudes_cuda(
            sig, ops.double(), 320, length, t, f),
        "cqt_short": lambda: tcqtslab._cqt_magnitudes_cuda(
            sig[:-1], ops, 320, length, t, f),
        "cqt_step": lambda: tcqtslab._cqt_magnitudes_cuda(
            sig, ops, 0, length, t, f),
        "mirror_f64": lambda: tmirror._mirror_full_planes_cuda(
            half.to(torch.complex128), wl),
        "mirror_width": lambda: tmirror._mirror_full_planes_cuda(
            half[:, :-1], wl),
        "fold_f64": lambda: tmirror._fold_half_planes_cuda(
            full.to(torch.complex128), wl),
        "fold_width": lambda: tmirror._fold_half_planes_cuda(
            full[:, :-1], wl),
        "fold_0d": lambda: tmirror._fold_half_planes_cuda(full[0, 0], wl),
        "full_f64": lambda: tfused._frames_rfft_cuda(
            padded.double(), win, wl, step, t, full=True),
        "full_short": lambda: tfused._frames_rfft_cuda(
            padded[:-1], win, wl, step, t, full=True),
        "full_ops": lambda: tfused._frames_rfft_cuda(
            padded, win, wl, step, t,
            ops=tfused.rdft_ops(wl, torch.float32, "cpu")[:, :, :-64],
            full=True),
    }
    return calls[case]()


@pytest.mark.parametrize("case", [
    "cqt_f64", "cqt_ops", "cqt_ops_dtype", "cqt_short", "cqt_step",
    "mirror_f64", "mirror_width", "fold_f64", "fold_width", "fold_0d",
    "full_f64", "full_short", "full_ops"])
def test_b3_b10_b11_cuda_wrappers_refuse_before_launch(case, monkeypatch):
    """The CQT, mirror, fold and full-spectrum wrappers check dtype, shapes,
    hop and operator before they touch the library: a type the kernel does
    not take raises NotImplementedError, the rest ValueError; nothing is
    launched or counted."""
    from zaftpu_torch.kernels import _build

    def no_library():
        raise AssertionError("the launch was reached")

    monkeypatch.setattr(_build, "library", no_library)
    launches = (_b3_b11_counts(), tfused.frames_rfft.launches)
    error = NotImplementedError if case.endswith("_f64") else ValueError
    with pytest.raises(error):
        _bad_b3_b11_launch(case)
    assert (_b3_b11_counts(), tfused.frames_rfft.launches) == launches


@pytest.mark.parametrize("wl,step,t", [(256, 128, 9), (255, 100, 6)])
def test_b3_b10_b11_batched_equal_per_item(wl, step, t):
    rng = np.random.default_rng(20)
    padded = torch.from_numpy(rng.standard_normal(
        (2, 3, t * step + wl - step)).astype(np.float32))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    # B3 and the GEMM half spectrum it shares: an explicit operator names
    # the GEMM at every window.
    gemm = tfused.rdft_ops(wl, torch.float32, "cpu")
    full = tfused.frames_rfft_full(padded, win, wl, step, t, ops=gemm)
    half = tfused.frames_rfft(padded, win, wl, step, t, ops=gemm)
    mirrored = tmirror.mirror_full_planes(half, wl)
    h_re, h_im = tmirror.fold_half_planes(full.transpose(-1, -2).contiguous()
                                          .transpose(-1, -2), wl)
    kern = zcqt.cqtkernel(8000, 12, 110.0, 880.0)
    ops = torch.from_numpy(tcqtslab.time_ops(kern.time_kernel))
    sig = torch.from_numpy(rng.standard_normal(
        (2, 3, (t - 1) * 320 + kern.fft_length)).astype(np.float32))
    mags = tcqtslab.cqt_magnitudes(sig, ops, 320, kern.fft_length, t,
                                   kern.number_frequencies)
    assert torch.equal(full, mirrored)
    for i in range(2):
        for j in range(3):
            one = padded[i, j]
            torch.testing.assert_close(full[i, j], tfused.frames_rfft_full(
                one, win, wl, step, t, ops=gemm))
            r, m = tmirror.fold_half_planes(full[i, j], wl)
            assert torch.equal(h_re[i, j], r) and torch.equal(h_im[i, j], m)
            torch.testing.assert_close(
                mags[i, j], tcqtslab.cqt_magnitudes(
                    sig[i, j], ops, 320, kern.fft_length, t,
                    kern.number_frequencies))
