"""Each zaftpu_torch kernel's plain version against the zaftpu Pallas kernel
it replaces (interpret mode), on the same numpy inputs and operators.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py compare them with these plain versions there). Here the
wrappers take their plain versions because the tensors lie on the CPU.
Shapes: WL 256 / hop 128 (K = 2) and WL 512 / hop 128 (K = 4), with T not a
multiple of 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zaftpu.core.windows import hamming
from zaftpu.pallas import framing as zframing
from zaftpu.pallas import fused as zfused
from zaftpu.pallas import ola as zola
from zaftpu.pallas import synth as zsynth
from zaftpu_torch import kernels as tkernels
from zaftpu_torch.core import fft as tfft
from zaftpu_torch.kernels import framing as tframing
from zaftpu_torch.kernels import fused as tfused
from zaftpu_torch.kernels import ola as tola
from zaftpu_torch.kernels import synth as tsynth

SHAPES = [(256, 128, 37), (512, 128, 61), (512, 128, 5)]


def _signal(wl, step, t, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(t * step + wl - step).astype(np.float32)


def _exact_close(mine, ref):
    np.testing.assert_allclose(mine, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


def _gemm_close(mine, ref):
    np.testing.assert_allclose(mine, ref, rtol=2e-6,
                               atol=2e-6 * np.abs(ref).max())


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
            tfused.frames_rfft.launches, tsynth.istft_ola.launches)


def test_cpu_tensors_take_plain_versions_only():
    wl, step, t = 256, 128, 9
    padded = torch.from_numpy(_signal(wl, step, t, 6))
    win = torch.from_numpy(hamming(wl).astype(np.float32))
    launches = _counts()
    calls = (tframing.frame_window_plain.calls, tola.overlap_add_plain.calls,
             tfused.frames_rfft_plain.calls, tsynth.istft_ola_plain.calls)
    frames = tframing.frame_window(padded, win, wl, step, t)
    tola.overlap_add(frames, step)
    half = tfused.frames_rfft(padded, win, wl, step, t)
    tsynth.istft_ola(half.real.contiguous(), half.imag.contiguous(), wl, step,
                     1.0)
    assert _counts() == launches
    assert (tframing.frame_window_plain.calls, tola.overlap_add_plain.calls,
            tfused.frames_rfft_plain.calls,
            tsynth.istft_ola_plain.calls) == tuple(c + 1 for c in calls)


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

