"""zaftpu_torch's CUDA kernels on the card: each against its plain version
(batched, ragged, general-hop and misaligned inputs), launch counts, the
stft/istft, mdct/imdct, spectrogram/mel/MFCC and CQT paths against the CPU
float64 path, the real-FFT analysis kernel and the shape rule that picks
it, the mirror, full-spectrum and two-output levers, the split4 twins
(B9's and B10's included) and the split4 dial, the CQT's scheme, the mel
kernels past the old shared-memory limit, the device and dtype rules
(float64 arrays, lists and bfloat16 signals), and the inputs the CUDA path
refuses.

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
                                  ola, rfft, synth)
from zaftpu_torch.transforms import mdct as tmdct
from zaftpu_torch.transforms.stft import centre_padded

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


def _half_plain(wl):
    """The plain version of the kernel frames_rfft launches at ``wl``."""
    return (rfft.frames_rfft_fft_plain if rfft.applies(wl)
            else fused.frames_rfft_plain)


def _oracle_half(padded, win, wl, step, t):
    """The float64 half spectrum of the windowed frames, on the CPU."""
    frames = padded.double().cpu().unfold(-1, wl, step)[..., :t, :]
    return torch.fft.rfft(frames * win.double().cpu(), dim=-1)


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
    ref = _half_plain(wl)(padded, win, wl, step, t)
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


@pytest.mark.parametrize("wl", [512, 500])
def test_batched_cuda_input_launches_once(dev, wl):
    """One launch for a batch, of the kernel the shape rule picks: the FFT
    at a power-of-two window, the GEMM otherwise; no plain version."""
    step, t = 128, 21
    padded, win = _inputs(wl, step, t, dev, (4,))

    def counts():
        return (fused.frames_rfft.launches, rfft.frames_rfft_fft.launches,
                fused.frames_rfft_plain.calls,
                rfft.frames_rfft_fft_plain.calls)

    before = counts()
    fused.frames_rfft(padded, win, wl, step, t)
    fft = rfft.applies(wl)
    assert counts() == (before[0] + (not fft), before[1] + fft, before[2],
                        before[3])


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


@pytest.mark.parametrize("mels", [1, 128, 256, 512, 800, 1024])
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


@pytest.mark.parametrize("mels", [800, 1024])
@pytest.mark.parametrize("split4", [False, True])
def test_mel_rows_past_the_old_shared_memory_limit(dev, mels, split4):
    """More mels than a bin tile's filterbank rows once fit in shared
    memory (745, 711 for the twin): the epilogue walks them in chunks, at
    WL 2048 through melspectrogram's own filterbank."""
    wl, step, t = 2048, 1024, 45
    padded, win = _inputs(wl, step, t, dev, (2,))
    fbt = torch.from_numpy(np.ascontiguousarray(zaftpu_torch.melfilterbank(
        44100, wl, mels).T.astype(np.float32))).to(dev)
    kernel, plain = (
        (melfused.mel_rows_split4, melfused.mel_rows_split4_plain) if split4
        else (melfused.mel_rows, melfused.mel_rows_plain))
    for power in (False, True):
        got = kernel(padded, win, fbt, wl, step, t, power)
        ref = plain(padded, win, fbt, wl, step, t, power)
        assert got.shape == ref.shape == (2, t, mels)
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
            "frames_rfft_fft": rfft.frames_rfft_fft.launches,
            "framing": framing.frame_window.launches,
            "ola": ola.overlap_add.launches}


def _calls():
    return (fused.frames_op_plain.calls, synth.imdct_ola_plain.calls,
            melfused.spec_rows_plain.calls, melfused.mel_rows_plain.calls,
            fused.frames_rfft_plain.calls, rfft.frames_rfft_fft_plain.calls)


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


@pytest.mark.parametrize("melfuse", ["auto", "0", "1"])
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
    # WL 2048: the FFT rule's half spectrum unless the lever forces the
    # magnitude and mel kernels.
    assert moved == ({"spec_rows", "mel_rows"} if melfuse == "1"
                     else {"frames_rfft_fft"})
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


@pytest.mark.parametrize("env,split4", [
    ({}, True), ({"ZAFTPU_PRECISION": "highest"}, False),
    ({"ZAFTPU_CQT_SCHEME": "exact"}, False),
    ({"ZAFTPU_PRECISION": "split4", "ZAFTPU_CQT_SCHEME": "exact"}, True),
    ({"ZAFTPU_PRECISION": "highest", "ZAFTPU_CQT_SCHEME": "split4"}, True)])
def test_cqt_on_card_matches_cpu_f64(dev, cqt_cache, env, split4,
                                     monkeypatch):
    """The CQT's scheme on the card: the split4 twin by default (within
    1e-4 of max of the CPU float64 path), the exact kernel under a pinned
    dial or ZAFTPU_CQT_SCHEME=exact (1e-5); no plain version runs."""
    monkeypatch.delenv("ZAFTPU_PRECISION", raising=False)
    monkeypatch.delenv("ZAFTPU_CQT_SCHEME", raising=False)
    cfg = zaftpu_torch.CqtConfig()
    x = np.random.default_rng(6).standard_normal((2, 3 * 44100))
    ref = zaftpu_torch.cqtspectrogram(torch.from_numpy(x), config=cfg)
    ref_chroma = zaftpu_torch.cqtchromagram(torch.from_numpy(x), config=cfg)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    x32 = torch.from_numpy(x.astype(np.float32)).to(dev)

    def counts():
        return (cqtslab.cqt_magnitudes.launches,
                cqtslab.cqt_magnitudes_split4.launches,
                cqtslab.cqt_magnitudes_plain.calls,
                cqtslab.cqt_magnitudes_split4_plain.calls)

    before = counts()
    spec = zaftpu_torch.cqtspectrogram(x32, config=cfg)
    chroma = zaftpu_torch.cqtchromagram(x32, config=cfg)
    moved = (0, 2) if split4 else (2, 0)
    assert counts() == (before[0] + moved[0], before[1] + moved[1],
                        before[2], before[3])
    assert spec.is_cuda and spec.dtype == torch.float32
    assert spec.shape == ref.shape and chroma.shape == ref_chroma.shape
    tol = 1e-4 if split4 else 1e-5
    assert _rel_err(spec.cpu().double(), ref) < tol
    assert _rel_err(chroma.cpu().double(), ref_chroma) < tol


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
    """B3 is bit-equal to the mirror of the GEMM half spectrum it shares a
    tile with (an explicit operator; without one at a window outside the
    FFT rule), and within 1e-5 of max of the float64 oracle: at a
    power-of-two window the default half spectrum is the FFT kernel's."""
    padded, win = _inputs(wl, step, t, dev, lead)
    full = fused.frames_rfft_full(padded, win, wl, step, t)
    half = fused.frames_rfft(padded, win, wl, step, t,
                             ops=fused.rdft_ops(wl, torch.float32, dev))
    assert full.shape == (*lead, t, wl)
    assert torch.equal(full, mirror.mirror_full_planes(half, wl))
    assert torch.equal(full, tfft.conjugate_mirror(half, wl))
    if not rfft.applies(wl):
        assert torch.equal(full, tfft.conjugate_mirror(
            fused.frames_rfft(padded, win, wl, step, t), wl))
    oracle = tfft.conjugate_mirror(_oracle_half(padded, win, wl, step, t), wl)
    assert _rel_err(full.cpu().to(torch.complex128), oracle) < 1e-5
    ref = fused.frames_rfft_full_plain(padded, win, wl, step, t)
    assert _rel_err(full, ref) < 2e-5


@pytest.mark.parametrize("levers,moved", [
    ({"ZAFTPU_MIRROR": "pallas"},
     {"frames_rfft_fft", "mirror_full_planes", "fold_half_planes", "synth"}),
    ({"ZAFTPU_FULLSPEC": "1"}, {"frames_rfft_full", "synth"})])
def test_mirror_and_fullspec_levers_on_card_bit_equal_default(
        dev, levers, moved, monkeypatch):
    """The mirror lever is bit-equal to the default. The full-spectrum
    kernel stays a GEMM while the default at WL 2048 is the FFT kernel, so
    under it stft and the round trip are held within 1e-5 of max of the
    CPU float64 path instead."""
    x64 = np.random.default_rng(7).standard_normal((2, 44100))
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    win = hamming(2048)
    ref = zaftpu_torch.stft(x, win, 1024)
    ref_rec = zaftpu_torch.istft(ref, win, 1024)
    for name, value in levers.items():
        monkeypatch.setenv(name, value)

    def launches():
        return {"frames_rfft": fused.frames_rfft.launches,
                "frames_rfft_fft": rfft.frames_rfft_fft.launches,
                "frames_rfft_full": fused.frames_rfft_full.launches,
                "mirror_full_planes": mirror.mirror_full_planes.launches,
                "fold_half_planes": mirror.fold_half_planes.launches,
                "synth": synth.istft_ola.launches}

    before = launches()
    spec = zaftpu_torch.stft(x, win, 1024)
    rec = zaftpu_torch.istft(spec, win, 1024)
    assert {k for k, v in launches().items() if v != before[k]} == moved
    if "ZAFTPU_FULLSPEC" not in levers:
        assert torch.equal(spec, ref)
        assert torch.equal(rec, ref_rec)
        return
    monkeypatch.delenv("ZAFTPU_FULLSPEC")
    oracle = zaftpu_torch.stft(torch.from_numpy(x64), win, 1024)
    assert _rel_err(spec.cpu().to(torch.complex128), oracle) < 1e-5
    assert _rel_err(rec.cpu().double(),
                    zaftpu_torch.istft(oracle, win, 1024)) < 1e-5


# The split4 twins (ZAFTPU_PRECISION=split4) and B12.

S4_SHAPES = SHAPES + [(512, 256, 37)]


@pytest.mark.parametrize("wl,step,t", S4_SHAPES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
@pytest.mark.parametrize("offset", [0, 1])
def test_split4_analysis_twins_match_plain(dev, wl, step, t, lead, offset):
    """B1's, B2's, B3's and B12's twins against their plain versions, B3's
    and B12's bit-equal to B1's twin (with the mirror), on aligned and
    misaligned (scalar-load) signals."""
    padded, win = _inputs(wl, step, t, dev, lead, offset)
    args = (padded, win, wl, step, t)
    half = fused.frames_rfft_split4(*args)
    ref = fused.frames_rfft_split4_plain(*args)
    assert half.shape == ref.shape and _rel_err(half, ref) < 2e-5
    full = fused.frames_rfft_full_split4(*args)
    assert torch.equal(full, tfft.conjugate_mirror(half, wl))
    assert _rel_err(full, fused.frames_rfft_full_split4_plain(*args)) < 2e-5
    re, im = fused.frames_matmul2_split4(*args)
    assert torch.equal(torch.complex(re, im), half)
    pre, pim = fused.frames_matmul2_split4_plain(*args)
    assert _rel_err(torch.stack((re, im)), torch.stack((pre, pim))) < 2e-5
    if wl % 2 == 0:
        ops = policy.presplit(torch.from_numpy(
            tmdct._direct_forward_ops_padded(wl)).to(dev))
        got = fused.frames_op_split4(padded, win, ops, wl // 2, wl, step, t)
        ref = fused.frames_op_split4_plain(padded, win, ops, wl // 2, wl,
                                           step, t)
        assert got.shape == ref.shape and _rel_err(got, ref) < 2e-5


@pytest.mark.parametrize("wl,step,t", SHAPES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_frames_matmul2_bitwise_vs_frames_rfft(dev, wl, step, t, lead):
    """B12's planes equal B1's half spectrum bit for bit, FFT or GEMM as
    the shape rule picks, and the GEMM pair under an explicit operator."""
    padded, win = _inputs(wl, step, t, dev, lead)
    re, im = fused.frames_matmul2(padded, win, wl, step, t)
    assert re.shape == (*lead, t, wl // 2 + 1)
    half = fused.frames_rfft(padded, win, wl, step, t)
    assert torch.equal(torch.complex(re, im), half)
    plain = (rfft.frames_matmul2_fft_plain if rfft.applies(wl)
             else fused.frames_matmul2_plain)
    pre, pim = plain(padded, win, wl, step, t)
    assert _rel_err(torch.stack((re, im)), torch.stack((pre, pim))) < 2e-5
    ops = fused.rdft_ops(wl, torch.float32, dev)
    gre, gim = fused.frames_matmul2(padded, win, wl, step, t, ops)
    assert torch.equal(torch.complex(gre, gim),
                       fused.frames_rfft(padded, win, wl, step, t, ops))


@pytest.mark.parametrize("wl,step,t", S4_SHAPES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_split4_synthesis_twins_match_plain(dev, wl, step, t, lead):
    rng = np.random.default_rng(wl + t)
    f = wl // 2 + 1
    h = torch.from_numpy(rng.standard_normal((2, *lead, t, f)).astype(
        np.float32)).to(dev)
    got = synth.istft_ola_split4(h[0], h[1], wl, step, 0.5)
    ref = synth.istft_ola_split4_plain(h[0], h[1], wl, step, 0.5)
    assert got.shape == ref.shape and _rel_err(got, ref) < 2e-5
    if wl % 2 == 0:
        c = torch.from_numpy(rng.standard_normal((*lead, t, wl // 2)).astype(
            np.float32)).to(dev)
        wb = vorbis(wl).tobytes()
        got = synth.imdct_ola_split4(c, wl // 2, wb)
        ref = synth.imdct_ola_split4_plain(c, wl // 2, wb)
        assert got.shape == ref.shape and _rel_err(got, ref) < 2e-5


def _split4_launches():
    return {"fused_split4": fused.frames_rfft_split4.launches,
            "synth_split4": synth.istft_ola_split4.launches,
            "frames_op_split4": fused.frames_op_split4.launches,
            "imdct_ola_split4": synth.imdct_ola_split4.launches,
            "fused": fused.frames_rfft.launches,
            "synth": synth.istft_ola.launches,
            "frames_op": fused.frames_op.launches,
            "imdct_ola": synth.imdct_ola.launches}


def test_split4_paths_on_card_match_cpu_f64(dev, monkeypatch):
    """stft -> istft and mdct -> imdct under split4 on the card: the twins
    launch (and no exact kernel), the outputs sit within 1e-4 of max of the
    CPU float64 path, the round trips in (100, 125) dB."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 44100))
    hw, vw = hamming(2048), vorbis(2048)
    ref_spec = zaftpu_torch.stft(torch.from_numpy(x), hw, 1024)
    ref_coeffs = zaftpu_torch.mdct(torch.from_numpy(x), vw)
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    x32 = torch.from_numpy(x.astype(np.float32)).to(dev)
    before = _split4_launches()
    spec = zaftpu_torch.stft(x32, hw, 1024)
    rec = zaftpu_torch.istft(spec, hw, 1024)
    coeffs = zaftpu_torch.mdct(x32, vw)
    rec2 = zaftpu_torch.imdct(coeffs, vw)
    moved = {k for k, v in _split4_launches().items() if v != before[k]}
    assert moved == {"fused_split4", "synth_split4", "frames_op_split4",
                     "imdct_ola_split4"}
    assert _rel_err(spec.cpu().to(torch.complex128), ref_spec) < 1e-4
    assert _rel_err(coeffs.cpu().double(), ref_coeffs) < 1e-4
    for r in (rec, rec2):
        err = r.cpu().double()[..., :x.shape[-1]] - torch.from_numpy(x)
        snr = 10 * np.log10((x ** 2).sum() / float((err ** 2).sum()))
        assert 100.0 < snr < 125.0


@pytest.mark.parametrize("lever", ["ZAFTPU_FUSED2", "ZAFTPU_FULLSPEC"])
@pytest.mark.parametrize("dial", ["highest", "split4"])
def test_fused2_and_fullspec_levers_on_card_bit_equal(dev, lever, dial,
                                                      monkeypatch):
    """Each lever's kernel shares the default's tile, so stft is bit-equal
    to the default, except B3 on the exact dial: a GEMM beside the default
    FFT kernel, held within 1e-5 of max of the CPU float64 path."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    x64 = np.random.default_rng(12).standard_normal((2, 44100))
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    win = hamming(2048)
    ref = zaftpu_torch.stft(x, win, 1024)
    monkeypatch.setenv(lever, "1")
    kernel = {("ZAFTPU_FUSED2", "highest"): rfft.frames_matmul2_fft,
              ("ZAFTPU_FUSED2", "split4"): fused.frames_matmul2_split4,
              ("ZAFTPU_FULLSPEC", "highest"): fused.frames_rfft_full,
              ("ZAFTPU_FULLSPEC", "split4"): fused.frames_rfft_full_split4
              }[lever, dial]
    before = kernel.launches
    spec = zaftpu_torch.stft(x, win, 1024)
    assert kernel.launches == before + 1
    if (lever, dial) != ("ZAFTPU_FULLSPEC", "highest"):
        assert torch.equal(spec, ref)
        return
    oracle = zaftpu_torch.stft(torch.from_numpy(x64), win, 1024)
    assert _rel_err(spec.cpu().to(torch.complex128), oracle) < 1e-5


ENTRY_POINTS = ["stft", "istft", "spectrogram", "mdct", "imdct",
                "melspectrogram", "mfcc", "cqtspectrogram", "cqtchromagram"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_numpy_input_runs_on_the_card(dev, name, cqt_cache):
    """The device rule: a numpy signal (spectrum, coefficients) goes to the
    card; the same input as a CPU tensor stays on the CPU."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal(8000).astype(np.float32)
    win, vw = hamming(512), vorbis(512)
    fb = zaftpu_torch.melfilterbank(8000, 512, 20)
    kern = zaftpu_torch.cqtkernel(8000, 12, 110.0, 880.0)
    spec = zaftpu_torch.stft(torch.from_numpy(x), win, 256).numpy()
    coeffs = zaftpu_torch.mdct(torch.from_numpy(x), vw).numpy()
    calls = {
        "stft": lambda a: zaftpu_torch.stft(a, win, 256),
        "istft": lambda a: zaftpu_torch.istft(a, win, 256),
        "spectrogram": lambda a: zaftpu_torch.spectrogram(a, win, 256),
        "mdct": lambda a: zaftpu_torch.mdct(a, vw),
        "imdct": lambda a: zaftpu_torch.imdct(a, vw),
        "melspectrogram": lambda a: zaftpu_torch.melspectrogram(
            a, win, 256, fb),
        "mfcc": lambda a: zaftpu_torch.mfcc(a, win, 256, fb, 12),
        "cqtspectrogram": lambda a: zaftpu_torch.cqtspectrogram(
            a, 8000, 25, kern),
        "cqtchromagram": lambda a: zaftpu_torch.cqtchromagram(
            a, 8000, 25, 12, kern),
    }
    data = {"istft": spec, "imdct": coeffs}.get(name, x)
    assert calls[name](data).is_cuda
    assert calls[name](torch.from_numpy(data)).device.type == "cpu"


@pytest.mark.parametrize("value", ["high", "default"])
def test_tpu_pass_count_dials_refused_on_cuda(dev, value, monkeypatch):
    monkeypatch.setenv("ZAFTPU_PRECISION", value)
    x = torch.zeros(8192, device=dev)
    with pytest.raises(NotImplementedError, match=value):
        zaftpu_torch.stft(x, hamming(512), 256)
    with pytest.raises(NotImplementedError, match=value):
        zaftpu_torch.mdct(x, vorbis(512))


def test_forced_mel_kernel_under_split4_runs_the_twin_on_cuda(dev,
                                                              monkeypatch):
    """ZAFTPU_MELFUSE=1 under split4: spec_rows runs exact (no twin),
    melspectrogram and mfcc run the mel kernel's twin; the outputs sit
    within the split4 gates of the CPU float64 path."""
    x = np.random.default_rng(14).standard_normal((2, 44100))
    win = hamming(2048)
    fb = zaftpu_torch.melfilterbank(44100, 2048, 40)
    x64 = torch.from_numpy(x)
    refs = (zaftpu_torch.spectrogram(x64, win, 1024),
            zaftpu_torch.melspectrogram(x64, win, 1024, fb),
            zaftpu_torch.mfcc(x64, win, 1024, fb, 20))
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    monkeypatch.setenv("ZAFTPU_MELFUSE", "1")
    x32 = torch.from_numpy(x.astype(np.float32)).to(dev)

    def counts():
        return (melfused.spec_rows.launches, melfused.mel_rows.launches,
                melfused.mel_rows_split4.launches,
                melfused.mel_rows_split4_plain.calls)

    before = counts()
    spec = zaftpu_torch.spectrogram(x32, win, 1024)
    mel = zaftpu_torch.melspectrogram(x32, win, 1024, fb)
    mf = zaftpu_torch.mfcc(x32, win, 1024, fb, 20)
    assert counts() == (before[0] + 1, before[1], before[2] + 2, before[3])
    assert _rel_err(spec.cpu().double(), refs[0]) < 1e-5
    assert _rel_err(mel.cpu().double(), refs[1]) < 1e-4
    assert float((mf.cpu().double() - refs[2]).abs().max()) < 5e-3


@pytest.mark.parametrize("wl,step,t", S4_SHAPES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
@pytest.mark.parametrize("offset", [0, 1])
def test_mel_rows_split4_matches_plain(dev, wl, step, t, lead, offset):
    """B9's twin against its plain version on batched, ragged, general-hop
    and misaligned (scalar-load) signals, magnitude and power."""
    padded, win = _inputs(wl, step, t, dev, lead, offset)
    fbt = torch.rand(wl // 2, 20,
                     generator=torch.Generator().manual_seed(wl)).to(dev)
    for power in (False, True):
        got = melfused.mel_rows_split4(padded, win, fbt, wl, step, t, power)
        ref = melfused.mel_rows_split4_plain(padded, win, fbt, wl, step, t,
                                             power)
        assert got.shape == ref.shape == (*lead, t, 20)
        assert _rel_err(got, ref) < 2e-5


@pytest.mark.parametrize("mels", [1, 128, 711, 712, 800, 1024])
def test_mel_rows_split4_mel_counts(dev, mels):
    """Any mel count: the epilogue stages the filterbank 256 mels at a
    time beside the split4 tile (712 and more raised before the chunks)."""
    wl, step, t = 512, 128, 70
    padded, win = _inputs(wl, step, t, dev, (2,))
    fbt = torch.rand(wl // 2, mels,
                     generator=torch.Generator().manual_seed(mels)).to(dev)
    got = melfused.mel_rows_split4(padded, win, fbt, wl, step, t, True)
    ref = melfused.mel_rows_split4_plain(padded, win, fbt, wl, step, t, True)
    assert got.shape == ref.shape == (2, t, mels)
    assert _rel_err(got, ref) < 2e-5


@pytest.mark.parametrize("sr,bins,fmin,fmax,t", CQT_GEOMETRIES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_cqt_magnitudes_split4_match_plain(dev, cqt_cache, sr, bins, fmin,
                                           fmax, t, lead):
    kern = zaftpu_torch.cqtkernel(sr, bins, fmin, fmax)
    step, length, f = round(sr / 25), kern.fft_length, kern.number_frequencies
    ops = torch.from_numpy(cqtslab.time_ops_split4(kern.time_kernel)).to(
        device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(sr + t + 1)
    sig = torch.from_numpy(rng.standard_normal(
        (*lead, (t - 1) * step + length)).astype(np.float32)).to(dev)
    got = cqtslab.cqt_magnitudes_split4(sig, ops, step, length, t, f)
    ref = cqtslab.cqt_magnitudes_split4_plain(sig, ops, step, length, t, f)
    assert got.shape == ref.shape == (*lead, t, f)
    assert _rel_err(got, ref) < 2e-5


def test_cqt_magnitudes_split4_on_a_misaligned_signal(dev, cqt_cache):
    kern = zaftpu_torch.cqtkernel(44100, 24, 55.0, 3520.0)
    step, length, f = 1764, kern.fft_length, kern.number_frequencies
    ops = cqtslab.time_ops(kern.time_kernel)
    t = 33
    raw = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (t - 1) * step + length + 1).astype(np.float32)).to(dev)
    sig = raw[1:]
    assert sig.data_ptr() % 16 != 0
    # A float32 operator is split on the host.
    ops = torch.from_numpy(ops).to(dev)
    assert _rel_err(
        cqtslab.cqt_magnitudes_split4(sig, ops, step, length, t, f),
        cqtslab.cqt_magnitudes_split4_plain(sig, ops, step, length, t,
                                            f)) < 2e-5


# The real-FFT analysis kernel: B1 and B12 at power-of-two windows.

FFT_SHAPES = [(16, 4, 300), (16, 5, 37), (64, 1, 45), (256, 100, 61),
              (512, 128, 1001), (2048, 1024, 37), (2048, 683, 19),
              (4096, 1024, 9), (4096, 4096, 3)]


@pytest.mark.parametrize("wl,step,t", FFT_SHAPES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
@pytest.mark.parametrize("offset", [0, 1])
def test_fft_kernel_matches_plain(dev, wl, step, t, lead, offset):
    """Both stores against the plain version, which does the kernel's
    float32 operations in its order (gate 1e-6 of max), the planes
    bit-equal to the half spectrum, both within 2e-6 of max of the float64
    oracle; batched, ragged, hops that do not divide WL, and misaligned
    (scalar-load) signals."""
    padded, win = _inputs(wl, step, t, dev, lead, offset)
    half = rfft.frames_rfft_fft(padded, win, wl, step, t)
    ref = rfft.frames_rfft_fft_plain(padded, win, wl, step, t)
    assert half.shape == ref.shape == (*lead, t, wl // 2 + 1)
    assert half.dtype == torch.complex64
    assert _rel_err(half, ref) <= 1e-6
    re, im = rfft.frames_matmul2_fft(padded, win, wl, step, t)
    assert torch.equal(torch.complex(re, im), half)
    pre, pim = rfft.frames_matmul2_fft_plain(padded, win, wl, step, t)
    assert _rel_err(torch.stack((re, im)), torch.stack((pre, pim))) <= 1e-6
    oracle = _oracle_half(padded, win, wl, step, t)
    assert _rel_err(half.cpu().to(torch.complex128), oracle) < 2e-6


def test_fft_kernel_takes_an_hour_in_one_launch(dev):
    """One hour at 44.1 kHz, WL 2048 / hop 1024: 155,041 frames, 77,521
    blocks on grid x (more than grid y or z take), in one launch; its first
    and last 64 frames against the plain version of the same frames."""
    wl, step, n = 2048, 1024, 3600 * 44100
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(n, device=dev, generator=gen)
    padded, t = centre_padded(x, wl, step)
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
    before = rfft.frames_rfft_fft.launches
    half = fused.frames_rfft(padded, win, wl, step, t)
    assert rfft.frames_rfft_fft.launches == before + 1
    assert half.shape == (t, wl // 2 + 1) and t == 155041
    span = 63 * step + wl
    head = rfft.frames_rfft_fft_plain(padded[:span], win, wl, step, 64)
    tail = rfft.frames_rfft_fft_plain(padded[(t - 64) * step:][:span], win,
                                      wl, step, 64)
    assert _rel_err(half[:64], head) <= 1e-6
    assert _rel_err(half[-64:], tail) <= 1e-6


@pytest.mark.parametrize("wl", [16, 256, 2048, 4096, 100, 1764])
@pytest.mark.parametrize("fused2", [False, True])
def test_shape_rule_launch_counts_on_card(dev, wl, fused2, monkeypatch):
    """stft launches the FFT kernel (its half or, with ZAFTPU_FUSED2=1, its
    planes store) at a power-of-two window and the GEMM kernel otherwise,
    once, and no plain version; within 1e-5 of max of the float64 path."""
    if fused2:
        monkeypatch.setenv("ZAFTPU_FUSED2", "1")
    x64 = np.random.default_rng(wl).standard_normal((2, 20000))
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    counters = {"gemm": fused.frames_rfft, "gemm2": fused.frames_matmul2,
                "fft": rfft.frames_rfft_fft, "fft2": rfft.frames_matmul2_fft}
    plains = (fused.frames_rfft_plain, fused.frames_matmul2_plain,
              rfft.frames_rfft_fft_plain, rfft.frames_matmul2_fft_plain)
    before = {k: c.launches for k, c in counters.items()}
    calls = [p.calls for p in plains]
    win = hamming(wl)
    spec = zaftpu_torch.stft(x, win, wl // 2)
    moved = {k for k, c in counters.items() if c.launches != before[k]}
    want = ("fft" if rfft.applies(wl) else "gemm") + ("2" if fused2 else "")
    assert moved == {want} and counters[want].launches == before[want] + 1
    assert [p.calls for p in plains] == calls
    monkeypatch.delenv("ZAFTPU_FUSED2", raising=False)
    oracle = zaftpu_torch.stft(torch.from_numpy(x64), win, wl // 2)
    assert _rel_err(spec.cpu().to(torch.complex128), oracle) < 1e-5


# The dtype rules on the card: float64 arrays and lists, bfloat16 signals.

def _entry_calls(cqt_kern):
    win, vw = hamming(512), vorbis(512)
    fb = zaftpu_torch.melfilterbank(8000, 512, 20)
    return {
        "stft": lambda a: zaftpu_torch.stft(a, win, 256),
        "istft": lambda a: zaftpu_torch.istft(a, win, 256),
        "spectrogram": lambda a: zaftpu_torch.spectrogram(a, win, 256),
        "mdct": lambda a: zaftpu_torch.mdct(a, vw),
        "imdct": lambda a: zaftpu_torch.imdct(a, vw),
        "melspectrogram": lambda a: zaftpu_torch.melspectrogram(
            a, win, 256, fb),
        "mfcc": lambda a: zaftpu_torch.mfcc(a, win, 256, fb, 12),
        "cqtspectrogram": lambda a: zaftpu_torch.cqtspectrogram(
            a, 8000, 25, cqt_kern),
        "cqtchromagram": lambda a: zaftpu_torch.cqtchromagram(
            a, 8000, 25, 12, cqt_kern),
    }


@pytest.mark.parametrize("name", ENTRY_POINTS)
@pytest.mark.parametrize("kind", ["float64", "list"])
def test_float64_arrays_and_lists_run_on_the_card(dev, name, kind,
                                                  cqt_cache):
    """A float64 numpy array (numpy's default, what wavread returns) or a
    list goes to the card as float32, a complex128 spectrum as complex64:
    the same result as the float32 (complex64) tensor on the card."""
    x = np.random.default_rng(16).standard_normal(8000)
    calls = _entry_calls(zaftpu_torch.cqtkernel(8000, 12, 110.0, 880.0))
    data = {"istft": np.ascontiguousarray(
                zaftpu_torch.stft(torch.from_numpy(x), hamming(512),
                                  256).numpy()),
            "imdct": np.ascontiguousarray(
                zaftpu_torch.mdct(torch.from_numpy(x), vorbis(512)).numpy())
            }.get(name, x)
    assert data.dtype in (np.float64, np.complex128)
    got = calls[name](data if kind == "float64" else data.tolist())
    tensor = torch.from_numpy(data).to(
        dev, torch.complex64 if data.dtype == np.complex128 else torch.float32)
    want = calls[name](tensor)
    assert got.is_cuda and got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_bf16_signal_runs_on_the_card(dev, name, cqt_cache):
    """A bfloat16 signal on the card is promoted to float32 before the
    kernels: the float32 result of the same values, returned as bfloat16
    by mdct and imdct (of mdct's bfloat16 coefficients), as zaftpu's engine
    path returns them."""
    x = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (2, 8000)).astype(np.float32)).to(dev, torch.bfloat16)
    calls = _entry_calls(zaftpu_torch.cqtkernel(8000, 12, 110.0, 880.0))
    vw = vorbis(512)
    if name == "istft":
        got = calls["istft"](calls["stft"](x))
        want = calls["istft"](calls["stft"](x.float()))
    elif name == "imdct":
        coeffs = calls["mdct"](x)
        got = calls["imdct"](coeffs)
        want = zaftpu_torch.imdct(coeffs.float(), vw).to(torch.bfloat16)
    else:
        got = calls[name](x)
        want = calls[name](x.float())
        if name == "mdct":
            want = want.to(torch.bfloat16)
    assert got.is_cuda and got.dtype == want.dtype
    assert got.dtype == (torch.bfloat16 if name in ("mdct", "imdct")
                         else want.dtype)
    assert torch.equal(got, want)
