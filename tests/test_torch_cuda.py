"""zaftpu_torch's CUDA kernels on the card: each against its plain version
(batched, ragged, general-hop and misaligned inputs), launch counts, the
whole stft/istft path against the CPU float64 path, and the inputs the
CUDA path refuses.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one.
This file imports neither JAX nor zaftpu, so on a machine without JAX it
runs with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import zaftpu_torch
from zaftpu_torch.core import policy
from zaftpu_torch.core.windows import hamming
from zaftpu_torch.kernels import framing, fused, ola, synth

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


SHAPES = [(2048, 1024, 37), (512, 128, 61), (256, 128, 5), (64, 24, 10),
          (100, 100, 7)]


def _inputs(wl, step, t, dev, lead=(), offset=0):
    rng = np.random.default_rng(wl + t)
    length = (t - 1) * step + wl + offset
    padded = torch.from_numpy(rng.standard_normal(
        (*lead, length)).astype(np.float32)).to(dev)[..., offset:]
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
    return padded, win


def _rel_err(got, ref):
    g = torch.view_as_real(got) if got.is_complex() else got
    r = torch.view_as_real(ref) if ref.is_complex() else ref
    return float((g - r).abs().max() / r.abs().max())


@pytest.mark.parametrize("wl,step,t", SHAPES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_kernels_match_plain(dev, wl, step, t, lead):
    padded, win = _inputs(wl, step, t, dev, lead)
    frames = framing.frame_window(padded, win, wl, step, t)
    ref = framing.frame_window_plain(padded, win, wl, step, t)
    assert torch.equal(frames, ref)
    got = ola.overlap_add(frames, step)
    ref = ola.overlap_add_plain(frames, step)
    assert got.shape == ref.shape
    if wl % step == 0:
        assert torch.equal(got, ref)
    else:  # the plain scatter-add sums in frame order, the kernel c-ascending
        assert _rel_err(got, ref) < 1e-6
    half = fused.frames_rfft(padded, win, wl, step, t)
    ref = fused.frames_rfft_plain(padded, win, wl, step, t)
    assert half.shape == ref.shape and _rel_err(half, ref) < 2e-5
    h_re, h_im = half.real.contiguous(), half.imag.contiguous()
    got = synth.istft_ola(h_re, h_im, wl, step, 0.5)
    ref = synth.istft_ola_plain(h_re, h_im, wl, step, 0.5)
    assert got.shape == ref.shape and _rel_err(got, ref) < 2e-5


def test_misaligned_signal_takes_the_scalar_framing(dev):
    wl, step, t = 512, 128, 9
    padded, win = _inputs(wl, step, t, dev, offset=1)
    assert padded.data_ptr() % 16 != 0
    got = framing.frame_window(padded, win, wl, step, t)
    assert torch.equal(got, framing.frame_window_plain(padded, win, wl, step,
                                                       t))


def test_batched_cuda_input_launches_once(dev):
    wl, step, t = 512, 128, 21
    padded, win = _inputs(wl, step, t, dev, (4,))
    before = (fused.frames_rfft.launches, fused.frames_rfft_plain.calls)
    fused.frames_rfft(padded, win, wl, step, t)
    assert (fused.frames_rfft.launches,
            fused.frames_rfft_plain.calls) == (before[0] + 1, before[1])


@pytest.mark.parametrize("split", [False, True])
def test_stft_istft_on_card_match_cpu_f64(dev, split, monkeypatch):
    if split:
        monkeypatch.setenv("ZAFTPU_FUSED", "0")
        monkeypatch.setenv("ZAFTPU_SYNTH", "0")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 44100))
    win = hamming(2048)
    ref = zaftpu_torch.stft(torch.from_numpy(x), win, 1024)
    spec = zaftpu_torch.stft(torch.from_numpy(x.astype(np.float32)).to(dev),
                             win, 1024)
    assert spec.is_cuda and spec.dtype == torch.complex64
    assert _rel_err(spec.cpu().to(torch.complex128), ref) < 1e-5
    rec = zaftpu_torch.istft(spec, win, 1024)
    rec_ref = zaftpu_torch.istft(ref, win, 1024)
    assert rec.is_cuda and _rel_err(rec.cpu().double(), rec_ref) < 1e-5
    contiguous = zaftpu_torch.istft(spec.contiguous(), win, 1024)
    assert torch.equal(rec, contiguous)


def test_cuda_path_refuses_what_kernels_do_not_take(dev):
    win = hamming(256)
    with pytest.raises(NotImplementedError, match="float32"):
        zaftpu_torch.stft(torch.zeros(4096, dtype=torch.float64, device=dev),
                          win, 128)
    with pytest.raises(NotImplementedError, match="four-step"):
        zaftpu_torch.stft(torch.zeros(20000, device=dev), hamming(8192),
                          4096)
    spec = torch.zeros((256, 10), dtype=torch.complex128, device=dev)
    with pytest.raises(NotImplementedError, match="complex64"):
        zaftpu_torch.istft(spec, win, 128)


def test_split_path_matmul_refuses_tf32(dev, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FUSED", "0")
    x = torch.zeros(4096, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            zaftpu_torch.stft(x, hamming(256), 128)
        with pytest.raises(RuntimeError, match="TF32"):
            policy.exact_matmul(x.reshape(64, 64), x.reshape(64, 64))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

