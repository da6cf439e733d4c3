"""zaftpu_torch's CUDA kernels on the card: each against its plain version
(batched, ragged, general-hop and misaligned inputs), launch counts, the
stft/istft, mdct/imdct, spectrogram/mel/MFCC and CQT paths against the CPU
float64 path, the mirror and full-spectrum levers, and the inputs the CUDA
path refuses.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one.
This file imports neither JAX nor zaftpu, so on a machine without JAX it
runs with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import zaftpu_torch
from zaftpu_torch.core import policy
from zaftpu_torch.core.windows import hamming, kbd, vorbis
from zaftpu_torch.core import fft as tfft
from zaftpu_torch.kernels import (cqtslab, framing, fused, melfused, mirror,
                                  ola, synth)
from zaftpu_torch.transforms import mdct as tmdct

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



@pytest.mark.parametrize("wl,step,t", SHAPES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_new_kernels_match_plain(dev, wl, step, t, lead):
    """frames_op, spec_rows and mel_rows (magnitude and power, 40 mels)."""
    padded, win = _inputs(wl, step, t, dev, lead)
    ops = torch.from_numpy(tmdct._direct_forward_ops_padded(wl)).to(dev)
    got = fused.frames_op(padded, win, ops, wl // 2, wl, step, t)
    ref = fused.frames_op_plain(padded, win, ops, wl // 2, wl, step, t)
    assert got.shape == ref.shape and _rel_err(got, ref) < 2e-5
    got = melfused.spec_rows(padded, win, wl, step, t)
    ref = melfused.spec_rows_plain(padded, win, wl, step, t)
    assert got.shape == ref.shape and _rel_err(got, ref) < 2e-5
    fbt = torch.rand(wl // 2, 40, generator=torch.Generator().manual_seed(t))
    fbt = fbt.to(dev)
    for power in (False, True):
        got = melfused.mel_rows(padded, win, fbt, wl, step, t, power)
        ref = melfused.mel_rows_plain(padded, win, fbt, wl, step, t, power)
        assert got.shape == ref.shape and _rel_err(got, ref) < 2e-5


@pytest.mark.parametrize("f,t", [(1024, 37), (100, 61), (128, 5), (8, 3),
                                 (256, 130)])
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_imdct_ola_matches_plain(dev, f, t, lead):
    """Includes F = 100 and 8 (16-row padding of the contraction) and the
    K = 2 edge rows at both ends of the output."""
    rng = np.random.default_rng(f + t)
    coeffs = torch.from_numpy(rng.standard_normal((*lead, t, f)).astype(
        np.float32)).to(dev)
    wb = vorbis(2 * f).tobytes()
    got = synth.imdct_ola(coeffs, f, wb)
    ref = synth.imdct_ola_plain(coeffs, f, wb)
    assert got.shape == ref.shape == (*lead, t * f + f)
    assert _rel_err(got, ref) < 2e-5
    scale = float(ref.abs().max())
    for edge in (slice(0, 2 * f), slice(-2 * f, None)):
        assert float((got[..., edge] - ref[..., edge]).abs().max()) \
            <= 2e-5 * scale
    # A transposed (non-contiguous) view is read as the same values.
    view = coeffs.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert torch.equal(synth.imdct_ola(view, f, wb), got)


@pytest.mark.parametrize("mels", [1, 128, 256, 512])
def test_mel_rows_mel_counts(dev, mels):
    wl, step, t = 512, 128, 70
    padded, win = _inputs(wl, step, t, dev, (2,))
    fbt = torch.rand(wl // 2, mels,
                     generator=torch.Generator().manual_seed(mels)).to(dev)
    for power in (False, True):
        got = melfused.mel_rows(padded, win, fbt, wl, step, t, power)
        ref = melfused.mel_rows_plain(padded, win, fbt, wl, step, t, power)
        assert got.shape == ref.shape == (2, t, mels)
        assert _rel_err(got, ref) < 2e-5


def test_mel_rows_past_shared_memory_raises(dev):
    """A filterbank tile too large for the card's shared memory per block
    raises; the error does not linger into the next launch."""
    wl, step, t = 512, 128, 70
    padded, win = _inputs(wl, step, t, dev, ())
    with pytest.raises(RuntimeError, match="zt_mel_rows"):
        melfused.mel_rows(padded, win, torch.ones(wl // 2, 4096, device=dev),
                          wl, step, t, False)
    fbt = torch.ones(wl // 2, 40, device=dev)
    got = melfused.mel_rows(padded, win, fbt, wl, step, t, False)
    ref = melfused.mel_rows_plain(padded, win, fbt, wl, step, t, False)
    assert _rel_err(got, ref) < 2e-5


def test_mdct_path_with_an_uneven_window_matches_cpu_f64(dev):
    """The reference's KBD example window has 510 samples: F = 255 pads the
    forward operator to 256 columns and the inverse contraction to 256
    rows."""
    win = kbd(512)
    x = np.random.default_rng(4).standard_normal((3, 20000))
    ref = zaftpu_torch.mdct(torch.from_numpy(x), win)
    coeffs = zaftpu_torch.mdct(torch.from_numpy(x.astype(np.float32)).to(dev),
                               win)
    assert _rel_err(coeffs.cpu().double(), ref) < 1e-5
    rec = zaftpu_torch.imdct(coeffs, win)
    rec_ref = zaftpu_torch.imdct(ref, win)
    assert rec.shape == rec_ref.shape
    assert _rel_err(rec.cpu().double(), rec_ref) < 1e-5


def test_new_kernels_on_a_misaligned_signal(dev):
    wl, step, t = 512, 128, 9
    padded, win = _inputs(wl, step, t, dev, offset=1)
    assert padded.data_ptr() % 16 != 0
    ops = torch.from_numpy(tmdct._direct_forward_ops_padded(wl)).to(dev)
    assert _rel_err(fused.frames_op(padded, win, ops, wl // 2, wl, step, t),
                    fused.frames_op_plain(padded, win, ops, wl // 2, wl,
                                          step, t)) < 2e-5
    assert _rel_err(melfused.spec_rows(padded, win, wl, step, t),
                    melfused.spec_rows_plain(padded, win, wl, step,
                                             t)) < 2e-5
    fbt = torch.ones(wl // 2, 3, device=dev)
    assert _rel_err(
        melfused.mel_rows(padded, win, fbt, wl, step, t, True),
        melfused.mel_rows_plain(padded, win, fbt, wl, step, t, True)) < 2e-5


def _launches():
    return {"frames_op": fused.frames_op.launches,
            "imdct_ola": synth.imdct_ola.launches,
            "spec_rows": melfused.spec_rows.launches,
            "mel_rows": melfused.mel_rows.launches,
            "frames_rfft": fused.frames_rfft.launches,
            "framing": framing.frame_window.launches,
            "ola": ola.overlap_add.launches}


def _calls():
    return (fused.frames_op_plain.calls, synth.imdct_ola_plain.calls,
            melfused.spec_rows_plain.calls, melfused.mel_rows_plain.calls,
            fused.frames_rfft_plain.calls)


@pytest.mark.parametrize("split", [False, True])
def test_mdct_imdct_on_card_match_cpu_f64(dev, split, monkeypatch):
    if split:
        monkeypatch.setenv("ZAFTPU_FUSED", "0")
        monkeypatch.setenv("ZAFTPU_SYNTH", "0")
    x = np.random.default_rng(2).standard_normal((2, 44100))
    win = vorbis(2048)
    ref = zaftpu_torch.mdct(torch.from_numpy(x), win)
    before, calls = _launches(), _calls()
    coeffs = zaftpu_torch.mdct(
        torch.from_numpy(x.astype(np.float32)).to(dev), win)
    rec = zaftpu_torch.imdct(coeffs, win)
    moved = {k for k, v in _launches().items() if v != before[k]}
    assert moved == ({"framing", "ola"} if split
                     else {"frames_op", "imdct_ola"})
    assert _calls() == calls
    assert coeffs.is_cuda and coeffs.dtype == torch.float32
    assert _rel_err(coeffs.cpu().double(), ref) < 1e-5
    rec_ref = zaftpu_torch.imdct(ref, win)
    assert rec.is_cuda and _rel_err(rec.cpu().double(), rec_ref) < 1e-5


@pytest.mark.parametrize("melfuse", ["auto", "0"])
def test_mel_paths_on_card_match_cpu_f64(dev, melfuse, monkeypatch):
    monkeypatch.setenv("ZAFTPU_MELFUSE", melfuse)
    x = np.random.default_rng(3).standard_normal((2, 44100))
    win = hamming(2048)
    fb = zaftpu_torch.melfilterbank(44100, 2048, 40)
    x32 = torch.from_numpy(x.astype(np.float32)).to(dev)
    before, calls = _launches(), _calls()
    spec = zaftpu_torch.spectrogram(x32, win, 1024)
    mel = zaftpu_torch.melspectrogram(x32, win, 1024, fb)
    mf = zaftpu_torch.mfcc(x32, win, 1024, fb, 20)
    moved = {k for k, v in _launches().items() if v != before[k]}
    assert moved == ({"spec_rows", "mel_rows"} if melfuse == "auto"
                     else {"frames_rfft"})
    assert _calls() == calls
    x64 = torch.from_numpy(x)
    assert _rel_err(spec.cpu().double(),
                    zaftpu_torch.spectrogram(x64, win, 1024)) < 1e-5
    assert _rel_err(mel.cpu().double(),
                    zaftpu_torch.melspectrogram(x64, win, 1024, fb)) < 1e-5
    ref = zaftpu_torch.mfcc(x64, win, 1024, fb, 20)
    assert float((mf.cpu().double() - ref).abs().max()) < 5e-3


def test_new_cuda_paths_refuse_what_kernels_do_not_take(dev):
    x64 = torch.zeros(4096, dtype=torch.float64, device=dev)
    fb = zaftpu_torch.melfilterbank(8000, 256, 20)
    with pytest.raises(NotImplementedError, match="float32"):
        zaftpu_torch.mdct(x64, vorbis(256))
    with pytest.raises(NotImplementedError, match="float32"):
        zaftpu_torch.imdct(torch.zeros((128, 9), dtype=torch.float64,
                                       device=dev), vorbis(256))
    with pytest.raises(NotImplementedError, match="float32"):
        zaftpu_torch.spectrogram(x64, hamming(256), 128)
    with pytest.raises(NotImplementedError, match="float32"):
        zaftpu_torch.melspectrogram(x64, hamming(256), 128, fb)
    with pytest.raises(NotImplementedError, match="float32"):
        zaftpu_torch.mfcc(x64, hamming(256), 128, fb, 12)
    long = torch.zeros(20000, device=dev)
    with pytest.raises(NotImplementedError, match="four-step"):
        zaftpu_torch.mdct(long, vorbis(8192))
    with pytest.raises(NotImplementedError, match="four-step"):
        zaftpu_torch.imdct(torch.zeros((4096, 5), device=dev), vorbis(8192))
    with pytest.raises(NotImplementedError, match="four-step"):
        zaftpu_torch.spectrogram(long, hamming(8192), 4096)
    with pytest.raises(NotImplementedError, match="four-step"):
        zaftpu_torch.melspectrogram(
            long, hamming(8192), 4096,
            zaftpu_torch.melfilterbank(44100, 8192, 40))


@pytest.fixture
def cqt_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path))


CQT_GEOMETRIES = [
    (44100, 24, 55.0, 3520.0, 70),   # CqtConfig(): L 32,768, hop 1764, F 144
    (22050, 12, 110.0, 3520.0, 61),  # L 4096, hop 882 (scalar path), F 60
    (48000, 36, 60.0, 6000.0, 9),    # L 65,536, hop 1920, F 239
]


@pytest.mark.parametrize("sr,bins,fmin,fmax,t", CQT_GEOMETRIES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_cqt_magnitudes_match_plain(dev, cqt_cache, sr, bins, fmin, fmax, t,
                                    lead):
    kern = zaftpu_torch.cqtkernel(sr, bins, fmin, fmax)
    step, length, f = round(sr / 25), kern.fft_length, kern.number_frequencies
    ops = torch.from_numpy(cqtslab.time_ops(kern.time_kernel)).to(dev)
    rng = np.random.default_rng(sr + t)
    sig = torch.from_numpy(rng.standard_normal(
        (*lead, (t - 1) * step + length)).astype(np.float32)).to(dev)
    got = cqtslab.cqt_magnitudes(sig, ops, step, length, t, f)
    ref = cqtslab.cqt_magnitudes_plain(sig, ops, step, length, t, f)
    assert got.shape == ref.shape == (*lead, t, f)
    assert _rel_err(got, ref) < 2e-5


def test_cqt_magnitudes_on_a_misaligned_signal(dev, cqt_cache):
    kern = zaftpu_torch.cqtkernel(44100, 24, 55.0, 3520.0)
    step, length, f = 1764, kern.fft_length, kern.number_frequencies
    ops = torch.from_numpy(cqtslab.time_ops(kern.time_kernel)).to(dev)
    t = 33
    raw = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (t - 1) * step + length + 1).astype(np.float32)).to(dev)
    sig = raw[1:]
    assert sig.data_ptr() % 16 != 0
    assert _rel_err(cqtslab.cqt_magnitudes(sig, ops, step, length, t, f),
                    cqtslab.cqt_magnitudes_plain(sig, ops, step, length, t,
                                                 f)) < 2e-5


def test_cqt_on_card_matches_cpu_f64(dev, cqt_cache):
    cfg = zaftpu_torch.CqtConfig()
    x = np.random.default_rng(6).standard_normal((2, 3 * 44100))
    ref = zaftpu_torch.cqtspectrogram(x, config=cfg)
    ref_chroma = zaftpu_torch.cqtchromagram(x, config=cfg)
    x32 = torch.from_numpy(x.astype(np.float32)).to(dev)
    before = (cqtslab.cqt_magnitudes.launches,
              cqtslab.cqt_magnitudes_plain.calls)
    spec = zaftpu_torch.cqtspectrogram(x32, config=cfg)
    chroma = zaftpu_torch.cqtchromagram(x32, config=cfg)
    assert (cqtslab.cqt_magnitudes.launches,
            cqtslab.cqt_magnitudes_plain.calls) == (before[0] + 2, before[1])
    assert spec.is_cuda and spec.dtype == torch.float32
    assert spec.shape == ref.shape and chroma.shape == ref_chroma.shape
    assert _rel_err(spec.cpu().double(), ref) < 1e-5
    assert _rel_err(chroma.cpu().double(), ref_chroma) < 1e-5


def test_cuda_f64_cqt_raises(dev, cqt_cache):
    kern = zaftpu_torch.cqtkernel(8000, 12, 110.0, 880.0)
    x = torch.zeros(8000, dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError, match="float32"):
        zaftpu_torch.cqtspectrogram(x, 8000, 25, kern)
    with pytest.raises(NotImplementedError, match="float32"):
        zaftpu_torch.cqtchromagram(x, 8000, 25, 12, kern)


@pytest.mark.parametrize("n", [2048, 512, 256, 255, 100, 2])
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_mirror_and_fold_bitwise_vs_plain(dev, n, lead):
    rng = np.random.default_rng(n)
    t = 37
    half = torch.from_numpy(
        rng.standard_normal((*lead, t, n // 2 + 1))
        + 1j * rng.standard_normal((*lead, t, n // 2 + 1))).to(
            torch.complex64).to(dev)
    # Also one frame as a 1-D spectrum, and no frames at all, as the plain
    # versions take them.
    for view in (half, half[..., 0, :], half[..., :0, :]):
        assert torch.equal(mirror.mirror_full_planes(view, n),
                           mirror.mirror_full_planes_plain(view, n))
    z = torch.from_numpy(
        rng.standard_normal((*lead, t, n))
        + 1j * rng.standard_normal((*lead, t, n))).to(torch.complex64).to(dev)
    bins_major = z.transpose(-1, -2).contiguous().transpose(-1, -2)
    for view in (z, bins_major, z[..., 0, :], z[..., :0, :]):
        got = mirror.fold_half_planes(view, n)
        ref = mirror.fold_half_planes_plain(view, n)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("wl,step,t", SHAPES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_frames_rfft_full_bitwise_vs_half_and_mirror(dev, wl, step, t, lead):
    padded, win = _inputs(wl, step, t, dev, lead)
    full = fused.frames_rfft_full(padded, win, wl, step, t)
    half = fused.frames_rfft(padded, win, wl, step, t)
    assert full.shape == (*lead, t, wl)
    assert torch.equal(full, mirror.mirror_full_planes(half, wl))
    assert torch.equal(full, tfft.conjugate_mirror(half, wl))
    ref = fused.frames_rfft_full_plain(padded, win, wl, step, t)
    assert _rel_err(full, ref) < 2e-5


@pytest.mark.parametrize("levers,moved", [
    ({"ZAFTPU_MIRROR": "pallas"},
     {"frames_rfft", "mirror_full_planes", "fold_half_planes", "synth"}),
    ({"ZAFTPU_FULLSPEC": "1"}, {"frames_rfft_full", "synth"})])
def test_mirror_and_fullspec_levers_on_card_bit_equal_default(
        dev, levers, moved, monkeypatch):
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 44100)).astype(np.float32)).to(dev)
    win = hamming(2048)
    ref = zaftpu_torch.stft(x, win, 1024)
    ref_rec = zaftpu_torch.istft(ref, win, 1024)
    for name, value in levers.items():
        monkeypatch.setenv(name, value)

    def launches():
        return {"frames_rfft": fused.frames_rfft.launches,
                "frames_rfft_full": fused.frames_rfft_full.launches,
                "mirror_full_planes": mirror.mirror_full_planes.launches,
                "fold_half_planes": mirror.fold_half_planes.launches,
                "synth": synth.istft_ola.launches}

    before = launches()
    spec = zaftpu_torch.stft(x, win, 1024)
    rec = zaftpu_torch.istft(spec, win, 1024)
    assert {k for k, v in launches().items() if v != before[k]} == moved
    assert torch.equal(spec, ref)
    assert torch.equal(rec, ref_rec)
