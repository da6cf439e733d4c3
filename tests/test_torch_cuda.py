"""zaftpu_torch's CUDA kernels on the card: each against its plain version
(batched, ragged, general-hop and misaligned inputs), launch counts, the
stft/istft, mdct/imdct, spectrogram/mel/MFCC and CQT paths against the CPU
float64 path, the real-FFT analysis kernel, the inverse real-FFT synthesis
kernel and the shape rule that picks them, the spectral CQT kernel and
its rule, the mirror, full-spectrum and two-output levers, the split4
twins (B9's and B10's included) and the split4 dial, the CQT's scheme,
the mel kernels past the old shared-memory limit, the real-FFT kernel's
magnitude and mel stores and the front ends' route, the device and dtype
rules (float64 arrays, lists and bfloat16 signals), the inputs the
CUDA path refuses, and each sharded function on a one-rank NCCL world
against the unsharded transform.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one.
This file imports neither JAX nor zaftpu, so on a machine without JAX it
runs with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import os

import numpy as np
import pytest
import torch

import zaftpu_torch
from zaftpu_torch.core import policy
from zaftpu_torch.core.windows import hamming, kbd, vorbis
from zaftpu_torch.core import fft as tfft
from zaftpu_torch.kernels import (_build, cqtfft, cqtslab, framing, fused,
                                  irfft, melfft, melfused, mirror, ola, rfft,
                                  synth)
from zaftpu_torch.kernels import mdct as kmdct
from zaftpu_torch.transforms import cqt as tcqt
from zaftpu_torch.transforms import dct as tdct
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
    return (rfft.frames_rfft_fft_plain if rfft.half_applies(wl)
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
    assert got.shape == ref.shape and torch.equal(got, ref)
    half = fused.frames_rfft(padded, win, wl, step, t)
    ref = _half_plain(wl)(padded, win, wl, step, t)
    assert half.shape == ref.shape and _rel_err(half, ref) < 2e-5
    # An explicit operator names B4 at every window.
    h_re, h_im = half.real.contiguous(), half.imag.contiguous()
    ops = synth.istft_ops(wl, 0.5, torch.float32, dev)
    got = synth.istft_ola(h_re, h_im, wl, step, 0.5, ops)
    ref = synth.istft_ola_plain(h_re, h_im, wl, step, 0.5, ops)
    assert got.shape == ref.shape and _rel_err(got, ref) < 2e-5


def test_misaligned_signal_takes_the_scalar_framing(dev):
    wl, step, t = 512, 128, 9
    padded, win = _inputs(wl, step, t, dev, offset=1)
    assert padded.data_ptr() % 16 != 0
    got = framing.frame_window(padded, win, wl, step, t)
    assert torch.equal(got, framing.frame_window_plain(padded, win, wl, step,
                                                       t))


@pytest.mark.parametrize("wl", [512, 500, 502])
@pytest.mark.parametrize("operator", [False, True])
def test_batched_cuda_input_launches_once(dev, wl, operator):
    """One launch for a batch, of the kernel the shape rule picks: the FFT
    kernel's half store at every window from 16 to 4,096 (512, 500 on the
    static path, 502 = 2 * 251 through rfft_any's Bluestein), the GEMM
    with an explicit operator; no plain version."""
    step, t = 128, 21
    padded, win = _inputs(wl, step, t, dev, (4,))
    ops = fused.rdft_ops(wl, torch.float32, dev) if operator else None

    def counts():
        return (fused.frames_rfft.launches, rfft.frames_rfft_fft.launches,
                fused.frames_rfft_plain.calls,
                rfft.frames_rfft_fft_plain.calls)

    before = counts()
    fused.frames_rfft(padded, win, wl, step, t, ops)
    assert counts() == (before[0] + operator, before[1] + (not operator),
                        before[2], before[3])


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
    """float64 and complex128 are refused; a window above 4,096 runs (the
    framing kernel and torch.fft)."""
    win = hamming(256)
    with pytest.raises(NotImplementedError, match="float32"):
        zaftpu_torch.stft(torch.zeros(4096, dtype=torch.float64, device=dev),
                          win, 128)
    spec = zaftpu_torch.stft(torch.zeros(20000, device=dev), hamming(8192),
                             4096)
    assert spec.is_cuda and spec.shape == (8192, 6) and not spec.any()
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
        # The FFT layer's GEMMs: the four-step engine, the DCT's operator
        # and, under ZAFTPU_FFT=matmul, its embeddings and a window above
        # 4,096 on the four-step engine.
        monkeypatch.delenv("ZAFTPU_FUSED")
        with pytest.raises(RuntimeError, match="TF32"):
            tfft.matmul_fft(x.reshape(4, 1024))
        with pytest.raises(RuntimeError, match="TF32"):
            zaftpu_torch.dct(x.reshape(4, 1024), 2)
        monkeypatch.setenv("ZAFTPU_FFT", "matmul")
        with pytest.raises(RuntimeError, match="TF32"):
            tdct._dst_core(x.reshape(4, 1024), 4)
        with pytest.raises(RuntimeError, match="TF32"):
            zaftpu_torch.stft(torch.zeros(20000, device=dev), hamming(8192),
                              4096)
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
    K = 2 edge rows at both ends of the output. The operator is given: it
    names B7 where the MDCT rule would take the fast IMDCT kernel."""
    rng = np.random.default_rng(f + t)
    coeffs = torch.from_numpy(rng.standard_normal((*lead, t, f)).astype(
        np.float32)).to(dev)
    wb = vorbis(2 * f).tobytes()
    ops = synth.imdct_ops(f, wb, torch.float32, dev)
    before = synth.imdct_ola.launches
    got = synth.imdct_ola(coeffs, f, wb, ops)
    assert synth.imdct_ola.launches == before + 1
    ref = synth.imdct_ola_plain(coeffs, f, wb, ops)
    assert got.shape == ref.shape == (*lead, t * f + f)
    assert _rel_err(got, ref) < 2e-5
    scale = float(ref.abs().max())
    for edge in (slice(0, 2 * f), slice(-2 * f, None)):
        assert float((got[..., edge] - ref[..., edge]).abs().max()) \
            <= 2e-5 * scale
    # A transposed (non-contiguous) view is read as the same values.
    view = coeffs.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert torch.equal(synth.imdct_ola(view, f, wb, ops), got)


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
            "mdct_fft": kmdct.mdct_fft.launches,
            "imdct_ola_fft": kmdct.imdct_ola_fft.launches,
            "spec_rows": melfused.spec_rows.launches,
            "mel_rows": melfused.mel_rows.launches,
            "spec_rows_fft": melfft.spec_rows_fft.launches,
            "mel_rows_fft": melfft.mel_rows_fft.launches,
            "frames_rfft": fused.frames_rfft.launches,
            "frames_rfft_fft": rfft.frames_rfft_fft.launches,
            "framing": framing.frame_window.launches,
            "ola": ola.overlap_add.launches}


def _calls():
    return (fused.frames_op_plain.calls, synth.imdct_ola_plain.calls,
            kmdct.mdct_fft_plain.calls, kmdct.imdct_ola_fft_plain.calls,
            melfused.spec_rows_plain.calls, melfused.mel_rows_plain.calls,
            melfft.spec_rows_fft_plain.calls, melfft.mel_rows_fft_plain.calls,
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
                     else {"mdct_fft", "imdct_ola_fft"})
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
    # WL 2048: the FFT kernel's magnitude and mel stores by the shape rule,
    # ZAFTPU_MELFUSE=1 too; its half spectrum under ZAFTPU_MELFUSE=0.
    assert moved == ({"frames_rfft_fft"} if melfuse == "0"
                     else {"spec_rows_fft", "mel_rows_fft"})
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
    # A window above 4,096 runs on the card and gives the CPU's float64
    # values within 1e-5 * max.
    gen = torch.Generator(device=dev).manual_seed(14)
    long = torch.randn(20000, device=dev, generator=gen)
    fb8 = zaftpu_torch.melfilterbank(44100, 8192, 40)
    for call in (lambda a: zaftpu_torch.mdct(a, vorbis(8192)),
                 lambda a: zaftpu_torch.imdct(
                     torch.ones((4096, 5), dtype=a.dtype, device=a.device),
                     vorbis(8192)),
                 lambda a: zaftpu_torch.spectrogram(a, hamming(8192), 4096),
                 lambda a: zaftpu_torch.melspectrogram(a, hamming(8192), 4096,
                                                       fb8)):
        got = call(long)
        assert got.is_cuda and got.dtype == torch.float32
        assert _rel_err(got.cpu().double(), call(long.cpu().double())) < 1e-5


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


@pytest.mark.parametrize("matmul", [False, True])
@pytest.mark.parametrize("env,split4", [
    ({}, True), ({"ZAFTPU_PRECISION": "highest"}, False),
    ({"ZAFTPU_CQT_SCHEME": "exact"}, False),
    ({"ZAFTPU_PRECISION": "split4", "ZAFTPU_CQT_SCHEME": "exact"}, True),
    ({"ZAFTPU_PRECISION": "highest", "ZAFTPU_CQT_SCHEME": "split4"}, True)])
def test_cqt_on_card_matches_cpu_f64(dev, cqt_cache, env, split4, matmul,
                                     monkeypatch):
    """The CQT on the card at CqtConfig() (L 32,768): the spectral kernel
    under every scheme and dial (within 1e-5 of max of the CPU float64
    path); under ZAFTPU_FFT=matmul the scheme's time-domain kernel, the
    split4 twin by default (1e-4) and the exact one under a pinned dial or
    ZAFTPU_CQT_SCHEME=exact (1e-5); no plain version runs."""
    monkeypatch.delenv("ZAFTPU_PRECISION", raising=False)
    monkeypatch.delenv("ZAFTPU_CQT_SCHEME", raising=False)
    monkeypatch.delenv("ZAFTPU_FFT", raising=False)
    cfg = zaftpu_torch.CqtConfig()
    x = np.random.default_rng(6).standard_normal((2, 3 * 44100))
    ref = zaftpu_torch.cqtspectrogram(torch.from_numpy(x), config=cfg)
    ref_chroma = zaftpu_torch.cqtchromagram(torch.from_numpy(x), config=cfg)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if matmul:
        monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    x32 = torch.from_numpy(x.astype(np.float32)).to(dev)

    def counts():
        return (cqtfft.cqt_magnitudes_fft.launches,
                cqtslab.cqt_magnitudes.launches,
                cqtslab.cqt_magnitudes_split4.launches,
                cqtfft.cqt_magnitudes_fft_plain.calls,
                cqtslab.cqt_magnitudes_plain.calls,
                cqtslab.cqt_magnitudes_split4_plain.calls)

    before = counts()
    spec = zaftpu_torch.cqtspectrogram(x32, config=cfg)
    chroma = zaftpu_torch.cqtchromagram(x32, config=cfg)
    ran = 0 if not matmul else 2 if split4 else 1
    assert counts() == tuple(b + 2 * (i == ran)
                             for i, b in enumerate(before))
    assert spec.is_cuda and spec.dtype == torch.float32
    assert spec.shape == ref.shape and chroma.shape == ref_chroma.shape
    tol = 1e-4 if ran == 2 else 1e-5
    assert _rel_err(spec.cpu().double(), ref) < tol
    assert _rel_err(chroma.cpu().double(), ref_chroma) < tol


def test_cuda_f64_cqt_raises(dev, cqt_cache):
    kern = zaftpu_torch.cqtkernel(8000, 12, 110.0, 880.0)
    x = torch.zeros(8000, dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError, match="float32"):
        zaftpu_torch.cqtspectrogram(x, 8000, 25, kern)
    with pytest.raises(NotImplementedError, match="float32"):
        zaftpu_torch.cqtchromagram(x, 8000, 25, 12, kern)


# The spectral CQT kernel: B10 and B10-s4 at every power-of-two L up to
# 131,072 (at 65,536 on a cluster of two blocks, at 131,072 of four).

# (sr, bins per octave, fmin, fmax, T): CqtConfig() (L 32,768, hop 1,764,
# F 144) at T 1, 2 and 700; L 2,048 (hop 320, F 36), L 4,096 (hop 882, F
# 60) and L 16,384 (hop 1,764, F 72); L 65,536 from 27.5 Hz (hop 1,764, F
# 168) at T 1 and 300, and from 8 kHz, 3-12 Hz (hop 320, F 24); L 131,072
# from C0 at 44.1 kHz (hop 1,764, F 186) at T 1 and 200, from A0 at 96 kHz
# (hop 3,840, F 168) and from 8 kHz, 1.5-6 Hz (hop 320, F 24).
CQT_FFT_SHAPES = [(44100, 24, 55.0, 3520.0, 1), (44100, 24, 55.0, 3520.0, 2),
                  (44100, 24, 55.0, 3520.0, 700),
                  (8000, 12, 110.0, 880.0, 301),
                  (22050, 12, 110.0, 3520.0, 101),
                  (44100, 12, 55.0, 3520.0, 40),
                  (44100, 24, 27.5, 3520.0, 1),
                  (44100, 24, 27.5, 3520.0, 300),
                  (8000, 12, 3.0, 12.0, 57),
                  (44100, 24, 16.35, 3520.0, 1),
                  (44100, 24, 16.35, 3520.0, 200),
                  (96000, 24, 27.5, 3520.0, 40),
                  (8000, 12, 1.5, 6.0, 57)]


def _cqt_fft_counter(length):
    """The wrapper that counts the spectral kernel's launches at L: the
    two-block cluster's at 65,536, the four-block cluster's at 131,072."""
    return cqtfft.COUNTERS[cqtfft.cluster_size(length)]


def _cqt_fft_case(dense, step, t, dev, lead=(), offset=0, seed=0):
    """A signal of T frames (batch ``lead``, starting ``offset`` floats past
    an aligned address) and the kernel's device table."""
    length = dense.shape[1]
    n = (t - 1) * step + length
    rows = int(np.prod(lead, dtype=np.int64))
    flat = torch.from_numpy(np.random.default_rng(seed + t).standard_normal(
        rows * n + offset).astype(np.float32)).to(dev)
    sig = flat[offset:].reshape(*lead, n)
    table = cqtfft.device_table(cqtfft.kernel_table(dense), dev)
    return sig, table


@pytest.mark.parametrize("sr,bins,fmin,fmax,t", CQT_FFT_SHAPES)
@pytest.mark.parametrize("lead,offset", [((), 0), ((2, 3), 0), ((), 1),
                                         ((2,), 3)])
def test_cqt_fft_kernel_matches_plain(dev, cqt_cache, sr, bins, fmin, fmax,
                                      t, lead, offset):
    """The spectral kernel bit-equal to its plain version, which does the
    kernel's float32 operations in its order: batched, misaligned (1 or 3
    floats past an aligned address, the scalar framing), T = 1, 2 and 700
    at CqtConfig(), L 2,048, 4,096 and 16,384, L 65,536 on the two-block
    cluster and L 131,072 on the four-block one; one launch a call; and
    within 1e-6 of max of the float64 path (2e-6 at L 131,072, whose
    65,536-point float32 FFT read 1.03e-6 at C0 on the H100)."""
    kern = zaftpu_torch.cqtkernel(sr, bins, fmin, fmax)
    step = round(sr / 25)
    sig, table = _cqt_fft_case(kern.kernel, step, t, dev, lead, offset)
    if offset:
        assert sig.data_ptr() % 8 != 0
    counter = _cqt_fft_counter(kern.fft_length)
    before = counter.launches
    got = cqtfft.cqt_magnitudes_fft(sig, table, step, kern.fft_length, t)
    assert counter.launches == before + 1
    ref = cqtfft.cqt_magnitudes_fft_plain(sig, table, step, kern.fft_length,
                                          t)
    assert got.shape == ref.shape == (*lead, t, kern.number_frequencies)
    assert torch.equal(got, ref), _rel_err(got, ref)
    k_red, cols, mask = tcqt._device_oracle_kernel(kern, torch.device("cpu"))
    oracle = tcqt._cqt_apply(sig.cpu().double(), k_red, cols, mask, step,
                             kern.fft_length, t, 1024)
    tol = 1e-6 if kern.fft_length <= 65536 else 2e-6
    assert _rel_err(got.cpu().double(), oracle) < tol


@pytest.mark.parametrize("kind", ["dense", "high", "dense65536",
                                  "dense131072"])
def test_cqt_fft_kernel_on_foreign_kernels(dev, cqt_cache, kind):
    """A dense foreign kernel over every column of L 512 (40% zeros), the
    L 2,048 kernel with its even rows' bands moved above L/2, and a dense
    foreign kernel over every column of L 65,536 and of 131,072 (4 rows,
    half zeros: rows that read X from every block of the cluster): the
    conjugate reads, bit-equal to the plain version, batched and
    misaligned."""
    rng = np.random.default_rng(5)
    if kind == "dense":
        dense = (rng.standard_normal((10, 512))
                 + 1j * rng.standard_normal((10, 512))) / 512
        dense[rng.random(dense.shape) < 0.4] = 0
    elif kind.startswith("dense"):
        length = int(kind[5:])
        dense = (rng.standard_normal((4, length))
                 + 1j * rng.standard_normal((4, length))) / length
        dense[rng.random(dense.shape) < 0.5] = 0
    else:
        dense = zaftpu_torch.cqtkernel(8000, 12, 110.0, 880.0).kernel.copy()
        dense[::2] = np.roll(dense[::2, ::-1], 1, axis=1)
    step, t = 320, 57
    sig, table = _cqt_fft_case(dense, step, t, dev, (3,), 1)
    assert bool(cqtfft.kernel_table(dense).conj.any())
    got = cqtfft.cqt_magnitudes_fft(sig, table, step, dense.shape[1], t)
    ref = cqtfft.cqt_magnitudes_fft_plain(sig, table, step, dense.shape[1],
                                          t)
    assert got.shape == (3, t, dense.shape[0])
    assert torch.equal(got, ref), _rel_err(got, ref)


def test_cqt_fft_entry_takes_exactly_what_fits_takes(dev):
    """The CUDA entry takes exactly the FFT lengths cqtfft.fits takes and
    refuses every other before any launch: T = 0 returns after the
    checks."""
    lib = _build.library()
    buf = torch.zeros(16, device=dev)
    p = buf.data_ptr()
    for n in range(1, 300000):
        err = lib.zt_cqt_magnitudes_fft(p, p, p, p, p, p, p, 1, 300000, 0, n,
                                        1, 1, 0, 0, 0, 0, 0)
        assert (err == 0) is cqtfft.fits(n), (n, err)


@pytest.mark.parametrize("geometry,rule", [
    ((44100, 24, 55.0, 3520.0), True),   # CqtConfig(): L 32,768
    ((8000, 12, 110.0, 880.0), True),    # L 2,048
    ((8000, 12, 3.0, 12.0), True),       # L 65,536: the two-block cluster
    ((8000, 12, 1.5, 6.0), True),        # L 131,072: the four-block one
    ((8000, 12, 0.75, 3.0), False)])     # L 262,144: past the kernel
@pytest.mark.parametrize("env", [{}, {"ZAFTPU_CQT_SCHEME": "exact"},
                                 {"ZAFTPU_PRECISION": "split4"},
                                 {"ZAFTPU_FFT": "matmul"},
                                 {"ZAFTPU_FFT": "matmul",
                                  "ZAFTPU_CQT_SCHEME": "exact"}])
def test_cqt_launch_counts_on_card(dev, cqt_cache, geometry, rule, env,
                                   monkeypatch):
    """cqtspectrogram and cqtchromagram launch the spectral kernel, once
    each, at the rule's L (on a cluster of two at 65,536 and of four at
    131,072) under the default scheme, ZAFTPU_CQT_SCHEME=exact and
    ZAFTPU_PRECISION=split4, and nothing else; at L 262,144 and under
    ZAFTPU_FFT=matmul B10-s4 (default) or B10 (exact) launch, as before. No
    plain version runs."""
    for name in ("ZAFTPU_PRECISION", "ZAFTPU_CQT_SCHEME", "ZAFTPU_FFT"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    sr, bins = geometry[:2]
    kern = zaftpu_torch.cqtkernel(*geometry)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        2 * sr).astype(np.float32)).to(dev)
    kernels = (cqtfft.cqt_magnitudes_fft, cqtfft.cqt_magnitudes_fft_cluster,
               cqtfft.cqt_magnitudes_fft_cluster4, cqtslab.cqt_magnitudes,
               cqtslab.cqt_magnitudes_split4)
    plains = (cqtfft.cqt_magnitudes_fft_plain, cqtslab.cqt_magnitudes_plain,
              cqtslab.cqt_magnitudes_split4_plain)
    before = [k.launches for k in kernels], [p.calls for p in plains]
    zaftpu_torch.cqtspectrogram(x, sr, 25, kern)
    zaftpu_torch.cqtchromagram(x, sr, 25, bins, kern)
    if rule and "ZAFTPU_FFT" not in env:
        ran = kernels.index(_cqt_fft_counter(kern.fft_length))
    else:
        ran = 3 if "ZAFTPU_CQT_SCHEME" in env else 4
    assert [k.launches for k in kernels] == [
        b + 2 * (i == ran) for i, b in enumerate(before[0])]
    assert [p.calls for p in plains] == before[1]


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
    """B3 (the GEMM, which an explicit operator names at every window) is
    bit-equal to the mirror of the GEMM half spectrum it shares a tile
    with, and within 1e-5 of max of the float64 oracle."""
    padded, win = _inputs(wl, step, t, dev, lead)
    gemm = fused.rdft_ops(wl, torch.float32, dev)
    full = fused.frames_rfft_full(padded, win, wl, step, t, ops=gemm)
    half = fused.frames_rfft(padded, win, wl, step, t, ops=gemm)
    assert full.shape == (*lead, t, wl)
    assert torch.equal(full, mirror.mirror_full_planes(half, wl))
    assert torch.equal(full, tfft.conjugate_mirror(half, wl))
    oracle = tfft.conjugate_mirror(_oracle_half(padded, win, wl, step, t), wl)
    assert _rel_err(full.cpu().to(torch.complex128), oracle) < 1e-5
    ref = fused.frames_rfft_full_plain(padded, win, wl, step, t, gemm)
    assert _rel_err(full, ref) < 2e-5


@pytest.mark.parametrize("levers,moved", [
    ({"ZAFTPU_MIRROR": "pallas"},
     {"frames_rfft_fft", "mirror_full_planes", "fold_half_planes",
      "synth_fft"}),
    ({"ZAFTPU_FULLSPEC": "1"}, {"frames_rfft_full_fft", "synth_fft_full"}),
    ({"ZAFTPU_FULLSPEC": "0"}, {"frames_rfft_fft", "synth_fft_full"})])
def test_mirror_and_fullspec_levers_on_card_bit_equal_default(
        dev, levers, moved, monkeypatch):
    """At WL 2048 the default stft takes the FFT kernel's full store; the
    mirror lever and ZAFTPU_FULLSPEC=0 its half store (and the mirror
    kernel or the index mirror), ZAFTPU_FULLSPEC=1 the full store; istft
    the fused fold, under the mirror lever the fold kernel and the inverse
    on its planes: each bit-equal to the default, spectrum and round
    trip."""
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
                "frames_rfft_full_fft": rfft.frames_rfft_full_fft.launches,
                "mirror_full_planes": mirror.mirror_full_planes.launches,
                "fold_half_planes": mirror.fold_half_planes.launches,
                "synth": synth.istft_ola.launches,
                "synth_fft": irfft.istft_ola_fft.launches,
                "synth_fft_full": irfft.istft_ola_fft_full.launches}

    before = launches()
    spec = zaftpu_torch.stft(x, win, 1024)
    rec = zaftpu_torch.istft(spec, win, 1024)
    assert {k for k, v in launches().items() if v != before[k]} == moved
    assert torch.equal(spec, ref)
    assert torch.equal(rec, ref_rec)


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
    plain = (rfft.frames_matmul2_fft_plain if rfft.half_applies(wl)
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
    return {"fft": rfft.frames_rfft_fft.launches,
            "fused_split4": fused.frames_rfft_split4.launches,
            "synth_split4": synth.istft_ola_split4.launches,
            "frames_op_split4": fused.frames_op_split4.launches,
            "imdct_ola_split4": synth.imdct_ola_split4.launches,
            "fused": fused.frames_rfft.launches,
            "synth": synth.istft_ola.launches,
            "synth_fft": irfft.istft_ola_fft.launches,
            "synth_fft_full": irfft.istft_ola_fft_full.launches,
            "frames_op": fused.frames_op.launches,
            "imdct_ola": synth.imdct_ola.launches}


def test_split4_paths_on_card_match_cpu_f64(dev, monkeypatch):
    """stft -> istft and mdct -> imdct under split4 on the card with
    ZAFTPU_FFT=matmul, which keeps the STFT's twins at WL 2048: the twins
    compute everything (and no exact GEMM or FFT kernel), the spectrum and
    the coefficients within 1e-4 of max of the CPU float64 path, the round
    trips in (100, 125) dB."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 44100))
    hw, vw = hamming(2048), vorbis(2048)
    ref_spec = zaftpu_torch.stft(torch.from_numpy(x), hw, 1024)
    ref_coeffs = zaftpu_torch.mdct(torch.from_numpy(x), vw)
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
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
    to the default: the FFT kernel's planes (ZAFTPU_FUSED2=1) or full
    (ZAFTPU_FULLSPEC=1, as the default) store on both dials. With
    ZAFTPU_FFT=matmul the full-spectrum lever launches B3 or its twin,
    bit-equal to that dispatch's default (B1 or its twin and the mirror)
    and within 1e-5 (1e-4 under split4) of max of the CPU float64 path."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    x64 = np.random.default_rng(12).standard_normal((2, 44100))
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    win = hamming(2048)
    ref = zaftpu_torch.stft(x, win, 1024)
    monkeypatch.setenv(lever, "1")
    kernel = {"ZAFTPU_FUSED2": rfft.frames_matmul2_fft,
              "ZAFTPU_FULLSPEC": rfft.frames_rfft_full_fft}[lever]
    before = kernel.launches
    spec = zaftpu_torch.stft(x, win, 1024)
    assert kernel.launches == before + 1
    assert torch.equal(spec, ref)
    if lever != "ZAFTPU_FULLSPEC":
        return
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    gemm = (fused.frames_rfft_full_split4 if dial == "split4"
            else fused.frames_rfft_full)
    before = gemm.launches
    spec = zaftpu_torch.stft(x, win, 1024)
    assert gemm.launches == before + 1
    monkeypatch.delenv(lever)
    assert torch.equal(spec, zaftpu_torch.stft(x, win, 1024))
    oracle = zaftpu_torch.stft(torch.from_numpy(x64), win, 1024)
    tol = 1e-4 if dial == "split4" else 1e-5
    assert _rel_err(spec.cpu().to(torch.complex128), oracle) < tol


@pytest.mark.parametrize("wl,lever,fused2,kernel", [
    (2048, None, False, "fft_full"), (2048, None, True, "fft2"),
    (1102, None, False, "fft_full"), (1102, None, True, "fft2"),
    (262, None, False, "fft_full"), (262, None, True, "fft2"),
    (262, "matmul", False, "twin"), (262, "matmul", True, "twin2"),
    (2048, "matmul", False, "twin"), (2048, "matmul", True, "twin2"),
    (1764, "native", False, "fft_full")])
def test_split4_stft_takes_the_fft_where_the_rule_holds(dev, wl, lever,
                                                       fused2, kernel,
                                                       monkeypatch):
    """Under split4 stft launches the FFT kernel, once and nothing else:
    its full store (its planes store under ZAFTPU_FUSED2=1) at every window
    from 16 to 4,096 (WL 1102 = 2 * 19 * 29 through the odd-prime passes,
    262 = 2 * 131 through rfft_any's Bluestein); B1's twin (B12's) only
    with ZAFTPU_FFT=matmul;
    the FFT's spectrum bit-equal to the exact dial's, the twins' within
    1e-4 of max of the CPU float64 path."""
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    if lever is not None:
        monkeypatch.setenv("ZAFTPU_FFT", lever)
    if fused2:
        monkeypatch.setenv("ZAFTPU_FUSED2", "1")
    x64 = np.random.default_rng(wl + 1).standard_normal((2, 20000))
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    counters = {"fft": rfft.frames_rfft_fft, "fft2": rfft.frames_matmul2_fft,
                "fft_full": rfft.frames_rfft_full_fft,
                "twin": fused.frames_rfft_split4,
                "twin2": fused.frames_matmul2_split4,
                "gemm": fused.frames_rfft, "gemm2": fused.frames_matmul2}
    before = {k: c.launches for k, c in counters.items()}
    win = hamming(wl)
    spec = zaftpu_torch.stft(x, win, wl // 2)
    moved = {k for k, c in counters.items() if c.launches != before[k]}
    assert moved == {kernel} and counters[kernel].launches == before[kernel] + 1
    oracle = zaftpu_torch.stft(torch.from_numpy(x64), win, wl // 2)
    if kernel.startswith("fft"):
        monkeypatch.setenv("ZAFTPU_PRECISION", "highest")
        assert torch.equal(spec, zaftpu_torch.stft(x, win, wl // 2))
        assert _rel_err(spec.cpu().to(torch.complex128), oracle) < 1e-5
    else:
        assert _rel_err(spec.cpu().to(torch.complex128), oracle) < 1e-4


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
    """``high`` and ``default`` are no longer refused on the card: the
    transforms run, at every window from 16 to 4,096 (262 by Bluestein,
    510 on the static path) on the exact FFT kernels, and under
    ZAFTPU_FFT=matmul on B1's and B4's twins at 3 and 1 passes (within the
    dial's reach of the CPU float64 path)."""
    monkeypatch.setenv("ZAFTPU_PRECISION", value)
    p = {"high": 3, "default": 1}[value]
    tol = {3: 2e-5, 1: 3e-2}[p]
    x = torch.from_numpy(np.random.default_rng(21).standard_normal(
        8192).astype(np.float32))
    xd = x.to(dev)
    for wl, lever in ((262, None), (510, None), (262, "matmul")):
        if lever:
            monkeypatch.setenv("ZAFTPU_FFT", lever)
        before = (fused.frames_rfft_split4.launches,
                  synth.istft_ola_split4.launches)
        spec = zaftpu_torch.stft(xd, hamming(wl), wl // 2)
        rec = zaftpu_torch.istft(spec, hamming(wl), wl // 2)
        twins = (fused.frames_rfft_split4.launches - before[0],
                 synth.istft_ola_split4.launches - before[1])
        assert twins == ((1, 1) if lever else (0, 0))
        monkeypatch.delenv("ZAFTPU_FFT", raising=False)
        ref = zaftpu_torch.stft(x.double(), hamming(wl), wl // 2)
        assert _rel_err(spec.cpu().to(torch.complex128), ref) < tol
        assert rec.is_cuda
    coeffs = zaftpu_torch.mdct(xd, vorbis(1102))
    assert _rel_err(coeffs.cpu().double(),
                    zaftpu_torch.mdct(x.double(), vorbis(1102))) < tol
    monkeypatch.delenv("ZAFTPU_PRECISION")
    ref = zaftpu_torch.stft(xd, hamming(512), 256)
    monkeypatch.setenv("ZAFTPU_PRECISION", value)
    assert torch.equal(zaftpu_torch.stft(xd, hamming(512), 256), ref)
    # The windows above 4,096, the DCT / DST and Griffin-Lim run too.
    assert zaftpu_torch.stft(xd, hamming(8192), 4096).is_cuda
    assert zaftpu_torch.dct(xd[:4096], 2).is_cuda
    assert zaftpu_torch.griffin_lim(torch.ones((257, 9), device=dev),
                                    hamming(512), 256).is_cuda


def test_forced_mel_kernel_under_split4_runs_the_twin_on_cuda(dev,
                                                              monkeypatch):
    """ZAFTPU_MELFUSE=1 under split4 with ZAFTPU_FFT=matmul (at WL 2048
    the FFT rule gives the FFT kernel's stores otherwise): spec_rows runs
    exact (no twin), melspectrogram and mfcc run the mel kernel's twin; the
    outputs sit within the split4 gates of the CPU float64 path."""
    x = np.random.default_rng(14).standard_normal((2, 44100))
    win = hamming(2048)
    fb = zaftpu_torch.melfilterbank(44100, 2048, 40)
    x64 = torch.from_numpy(x)
    refs = (zaftpu_torch.spectrogram(x64, win, 1024),
            zaftpu_torch.melspectrogram(x64, win, 1024, fb),
            zaftpu_torch.mfcc(x64, win, 1024, fb, 20))
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    monkeypatch.setenv("ZAFTPU_MELFUSE", "1")
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
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


# The real-FFT analysis kernel: B1 and B12 (and, under split4, their twins)
# at every even window whose half has no prime factor above 127.

FFT_SHAPES = [(16, 4, 300), (16, 5, 37), (64, 1, 45), (256, 100, 61),
              (512, 128, 1001), (2048, 1024, 37), (2048, 683, 19),
              (4096, 1024, 9), (4096, 4096, 3),
              # Mixed radices: m = 12 (4, 3), 200 (4, 2, 5, 5), odd 441
              # (3, 3, 7, 7), 882 (2, 3, 3, 7, 7), 1500 (4, 3, 5, 5, 5; one
              # frame per block), ten frames per block at 400.
              (24, 6, 200), (400, 160, 1001), (400, 150, 61), (882, 441, 37),
              (882, 300, 37), (1764, 882, 37), (1764, 500, 19),
              (3000, 1000, 9), (3000, 3000, 3)]
# Primes above 7 (the generic odd-prime pass): m = 110 (2, 5, 11), 127 (one
# pass, sixteen frames per block), 143 (11, 13), 551 (19, 29), 1016 (4, 2,
# 127), 1331 (11, 11, 11) and 1411 (17, 83; one frame per block).
PRIME_SHAPES = [(220, 100, 61), (254, 127, 61), (286, 50, 40),
                (1102, 551, 37), (1102, 300, 19), (2032, 1000, 9),
                (2662, 1000, 7), (2822, 1411, 9)]


@pytest.mark.parametrize("wl,step,t", FFT_SHAPES + PRIME_SHAPES)
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


@pytest.mark.parametrize("wl,step,t", PRIME_SHAPES)
@pytest.mark.parametrize("lead,offset", [((), 0), ((3,), 1)])
def test_prime_passes_bit_equal_to_plain(dev, wl, step, t, lead, offset):
    """Through the generic odd-prime passes all three stores and the
    inverse kernel equal their plain versions bit for bit (every product
    and sum an explicitly rounded intrinsic in the plain version's order),
    one row and a batched, misaligned (scalar-load) case."""
    padded, win = _inputs(wl, step, t, dev, lead, offset)
    half = rfft.frames_rfft_fft(padded, win, wl, step, t)
    assert torch.equal(half, rfft.frames_rfft_fft_plain(padded, win, wl,
                                                        step, t))
    re, im = rfft.frames_matmul2_fft(padded, win, wl, step, t)
    assert torch.equal(torch.complex(re, im), half)
    assert torch.equal(rfft.frames_rfft_full_fft(padded, win, wl, step, t),
                       tfft.conjugate_mirror(half, wl))
    h_re, h_im = half.real.contiguous(), half.imag.contiguous()
    got = irfft.istft_ola_fft(h_re, h_im, wl, step, 0.5)
    assert torch.equal(got, irfft.istft_ola_fft_plain(h_re, h_im, wl, step,
                                                      0.5))


def test_fft_entry_refuses_what_the_rule_refuses(dev):
    """The half, planes and full entries take every length from 16 to
    4,096 with its Bluestein length (rfft.layout(WL).p, 0 where the passes
    take the FFT's own length); each refuses every other length and a
    wrong P before any launch (T = 0 returns after the checks); the
    wrappers raise ValueError on the same lengths."""
    lib = _build.library()
    buf = torch.zeros(8192, device=dev)
    p = buf.data_ptr()
    stores = (lib.zt_rfft_half, lib.zt_rfft_planes, lib.zt_rfft_full)
    for wl in range(1, 4200):
        big = rfft.layout(wl).p if melfft.fits(wl) else 0
        for entry in stores:
            err = entry(p, p, p, p, 1, 8192, 0, wl, 1, big, 0)
            assert (err == 0) is melfft.fits(wl), (wl, err)
    for wl, big in ((2048, 288), (441, 882), (262, 0), (2062, 2063),
                    (3093, 8194)):
        for entry in stores:
            assert entry(p, p, p, p, 1, 8192, 0, wl, 1, big, 0) != 0
    for wl in (255, 15, 4098):
        padded, win = _inputs(wl, wl // 2, 3, dev)
        if melfft.fits(wl):
            continue
        for wrapper in (rfft.frames_rfft_fft, rfft.frames_matmul2_fft,
                        rfft.frames_rfft_full_fft):
            with pytest.raises(ValueError, match="must be in"):
                wrapper(padded, win, wl, wl // 2, 3)


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


@pytest.mark.parametrize("wl", [16, 256, 2048, 4096, 100, 1764, 1102, 2822,
                                262, 2062])
@pytest.mark.parametrize("fused2", [False, True])
def test_shape_rule_launch_counts_on_card(dev, wl, fused2, monkeypatch):
    """stft launches the FFT kernel, once, and no plain version: its full
    store (its planes store with ZAFTPU_FUSED2=1) at every window from 16
    to 4,096 (262 = 2 * 131 and 2062 = 2 * 1031 by Bluestein); within 1e-5
    of max of the float64 path."""
    if fused2:
        monkeypatch.setenv("ZAFTPU_FUSED2", "1")
    x64 = np.random.default_rng(wl).standard_normal((2, 20000))
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    counters = {"gemm": fused.frames_rfft, "gemm2": fused.frames_matmul2,
                "fft": rfft.frames_rfft_fft, "fft2": rfft.frames_matmul2_fft,
                "fft_full": rfft.frames_rfft_full_fft,
                "gemm_full": fused.frames_rfft_full}
    plains = (fused.frames_rfft_plain, fused.frames_matmul2_plain,
              rfft.frames_rfft_fft_plain, rfft.frames_matmul2_fft_plain,
              rfft.frames_rfft_full_fft_plain, fused.frames_rfft_full_plain)
    before = {k: c.launches for k, c in counters.items()}
    calls = [p.calls for p in plains]
    win = hamming(wl)
    spec = zaftpu_torch.stft(x, win, wl // 2)
    moved = {k for k, c in counters.items() if c.launches != before[k]}
    want = "fft2" if fused2 else "fft_full"
    assert moved == {want} and counters[want].launches == before[want] + 1
    assert [p.calls for p in plains] == calls
    monkeypatch.delenv("ZAFTPU_FUSED2", raising=False)
    oracle = zaftpu_torch.stft(torch.from_numpy(x64), win, wl // 2)
    assert _rel_err(spec.cpu().to(torch.complex128), oracle) < 1e-5


# The FFT kernel's full store: B3 and B3-s4 at every even window whose half
# has no prime factor above 127.

@pytest.mark.parametrize("wl,step,t", FFT_SHAPES + PRIME_SHAPES + [
    (2048, 1024, 1), (400, 160, 1), (1102, 551, 1)])
@pytest.mark.parametrize("lead,offset", [((), 0), ((), 1), ((3,), 0),
                                         ((2, 3), 1)])
def test_fft_full_store_matches_plain(dev, wl, step, t, lead, offset):
    """The full store equals its plain version bit for bit (the kernel
    does the plain version's float32 operations in its order; the mirror's
    negation is exact) and the half store followed by the conjugate mirror;
    T = 1, ragged batches, and misaligned signal views (an odd storage
    offset: the scalar loads)."""
    padded, win = _inputs(wl, step, t, dev, lead, offset)
    before = rfft.frames_rfft_full_fft.launches
    full = rfft.frames_rfft_full_fft(padded, win, wl, step, t)
    assert rfft.frames_rfft_full_fft.launches == before + 1
    assert full.shape == (*lead, t, wl) and full.dtype == torch.complex64
    assert torch.equal(full, rfft.frames_rfft_full_fft_plain(padded, win, wl,
                                                             step, t))
    half = rfft.frames_rfft_fft(padded, win, wl, step, t)
    assert torch.equal(full, tfft.conjugate_mirror(half, wl))


def test_fft_full_store_takes_an_hour_in_one_launch(dev):
    """One hour at 44.1 kHz, WL 2048 / hop 1024 (155,041 frames, 2.5 GB of
    full spectrum) in one launch; its first and last 64 frames against the
    plain version of the same frames."""
    wl, step, n = 2048, 1024, 3600 * 44100
    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn(n, device=dev, generator=gen)
    padded, t = centre_padded(x, wl, step)
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
    before = rfft.frames_rfft_full_fft.launches
    full = fused.frames_rfft_full(padded, win, wl, step, t)
    assert rfft.frames_rfft_full_fft.launches == before + 1
    assert full.shape == (t, wl) and t == 155041
    span = 63 * step + wl
    head = rfft.frames_rfft_full_fft_plain(padded[:span], win, wl, step, 64)
    tail = rfft.frames_rfft_full_fft_plain(padded[(t - 64) * step:][:span],
                                           win, wl, step, 64)
    assert torch.equal(full[:64], head) and torch.equal(full[-64:], tail)


@pytest.mark.parametrize("wl", [2048, 1764])
@pytest.mark.parametrize("dial", ["highest", "split4"])
def test_default_stft_takes_the_full_store_on_both_dials(dev, wl, dial,
                                                         monkeypatch):
    """At a rule window the default stft launches the FFT kernel's full
    store once, and no half store, mirror kernel or GEMM; its spectrum and
    round trip equal ZAFTPU_FULLSPEC=0's (the half store and the index
    mirror) bit for bit, on both dials."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    x64 = np.random.default_rng(wl + 5).standard_normal((2, 44100))
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    win = hamming(wl)
    counters = (rfft.frames_rfft_full_fft, rfft.frames_rfft_fft,
                rfft.frames_matmul2_fft, mirror.mirror_full_planes,
                fused.frames_rfft_full, fused.frames_rfft_full_split4,
                fused.frames_rfft, fused.frames_rfft_split4)
    before = [c.launches for c in counters]
    spec = zaftpu_torch.stft(x, win, wl // 2)
    assert [c.launches for c in counters] == [before[0] + 1, *before[1:]]
    rec = zaftpu_torch.istft(spec, win, wl // 2)
    monkeypatch.setenv("ZAFTPU_FULLSPEC", "0")
    half = rfft.frames_rfft_fft.launches
    ref = zaftpu_torch.stft(x, win, wl // 2)
    assert rfft.frames_rfft_fft.launches == half + 1
    assert torch.equal(spec, ref)
    assert torch.equal(rec, zaftpu_torch.istft(ref, win, wl // 2))


# The inverse real-FFT + overlap-add kernel: B4 and B4-s4 at every even
# window whose half has no prime factor above 127.

IRFFT_SHAPES = [(2048, 1024, 37), (2048, 1024, 1), (1764, 882, 23),
                (400, 160, 61), (400, 160, 1), (4096, 256, 40), (16, 1, 700),
                (16, 5, 3000), (3000, 1000, 9), (3000, 3000, 3),
                (512, 100, 1001), (24, 7, 300),
                # Primes above 7: 220 (2, 5, 11), 254 (127) at hop 7, 1102
                # (19, 29), 2032 (4, 2, 127), 2662 (11, 11, 11), 2822 (17,
                # 83).
                (220, 110, 61), (254, 7, 300), (1102, 551, 23),
                (1102, 1102, 1), (2032, 500, 9), (2662, 1331, 5),
                (2822, 1411, 9)]


@pytest.mark.parametrize("wl,step,t", IRFFT_SHAPES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_irfft_kernel_matches_plain(dev, wl, step, t, lead):
    """Bit-equal to the plain version, which does the kernel's float32
    operations in its order, and within 2e-6 of max of the float64 path;
    batched, ragged, T = 1, hops that do not divide WL, K up to 16 and
    hop 1."""
    rng = np.random.default_rng(wl + step + t)
    h = rng.standard_normal((2, *lead, t, wl // 2 + 1)).astype(np.float32)
    h_re, h_im = (torch.from_numpy(a).to(dev) for a in h)
    before = irfft.istft_ola_fft.launches
    got = irfft.istft_ola_fft(h_re, h_im, wl, step, 0.5)
    assert irfft.istft_ola_fft.launches == before + 1
    ref = irfft.istft_ola_fft_plain(h_re, h_im, wl, step, 0.5)
    assert got.shape == ref.shape == (*lead, (t - 1) * step + wl)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref), _rel_err(got, ref)
    oracle = irfft.istft_ola_fft(*(torch.from_numpy(a).double() for a in h),
                                 wl, step, 0.5)
    assert _rel_err(got.cpu().double(), oracle) < 2e-6


@pytest.mark.parametrize("wl,step,t", IRFFT_SHAPES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
@pytest.mark.parametrize("layout", ["frames-major", "bins-major",
                                    "column slice"])
def test_irfft_fused_fold_matches_plain(dev, wl, step, t, lead, layout):
    """The fused fold (the full spectrum, the Hermitian fold read in the
    load) on a spectrum that is not Hermitian, frames-major, as the
    transposed view of a bins-major tensor, or a column slice of one (its
    frames from the second on): one launch, bit-equal to its plain version
    and to the index fold followed by the inverse on the folded planes
    (the route before the fold moved into the load)."""
    rng = np.random.default_rng(wl + step + t + 1)
    z = rng.standard_normal((2, *lead, t + 2, wl)).astype(np.float32)
    full = torch.complex(*(torch.from_numpy(a) for a in z)).to(dev)
    if layout != "frames-major":
        full = full.transpose(-1, -2).contiguous().transpose(-1, -2)
    full = full[..., 1:t + 1, :] if layout == "column slice" else \
        full[..., :t, :]
    before = irfft.istft_ola_fft_full.launches
    got = irfft.istft_ola_fft_full(full, wl, step, 0.5)
    assert irfft.istft_ola_fft_full.launches == before + 1
    ref = irfft.istft_ola_fft_full_plain(full, wl, step, 0.5)
    assert got.shape == ref.shape == (*lead, (t - 1) * step + wl)
    assert torch.equal(got, ref), _rel_err(got, ref)
    h_re, h_im = tfft.hermitian_fold_planes(full.real, full.imag, wl)
    assert torch.equal(got, irfft.istft_ola_fft(h_re, h_im, wl, step, 0.5))


@pytest.mark.parametrize("wl", [2048, 1764, 1102, 400, 2822, 16, 2062, 441,
                                3093, 4078])
@pytest.mark.parametrize("layout", ["stft", "bins-major"])
def test_istft_on_the_card_equals_the_fold_then_the_inverse(dev, wl,
                                                            layout):
    """istft at a static window or off the rule (irfft_any: 2,062 and
    4,078 by Bluestein, 441 odd, 3,093 odd by Bluestein; half overlap)
    launches the fused fold once
    and equals, bit for bit, the route before it, computed by hand: the
    index fold of the spectrum, the inverse kernel on its planes, the
    trim. The spectrum as stft returns it (a transposed view) and as a
    contiguous bins-major tensor."""
    from zaftpu_torch.core.frame import cola_gain

    gen = torch.Generator(device=dev).manual_seed(wl)
    x = torch.randn(2, 20 * wl, device=dev, generator=gen)
    win, step = hamming(wl), wl // 2
    spec = zaftpu_torch.stft(x, win, step)
    if layout == "bins-major":
        spec = spec.contiguous()
    before = (irfft.istft_ola_fft_full.launches, irfft.istft_ola_fft.launches)
    rec = zaftpu_torch.istft(spec, win, step)
    assert (irfft.istft_ola_fft_full.launches,
            irfft.istft_ola_fft.launches) == (before[0] + 1, before[1])
    fm = spec.transpose(-1, -2)
    h_re, h_im = tfft.hermitian_fold_planes(fm.real, fm.imag, wl)
    ref = irfft.istft_ola_fft(h_re, h_im, wl, step,
                              1.0 / cola_gain(np.asarray(win), step))
    edge = wl - step
    assert torch.equal(rec, ref[..., edge:ref.shape[-1] - edge])


def test_irfft_full_entry_refuses_what_the_rule_refuses(dev):
    """The fused fold's C entry takes every length from 16 to 4,096 with
    its Bluestein length (rfft.layout(N).p) and a hop in [1, N], and
    refuses every other, a wrong P and a misaligned spectrum, before any
    launch: T = 0 returns after the checks."""
    lib = _build.library()
    buf = torch.zeros(8192, device=dev)
    p = buf.data_ptr()
    for wl in range(1, 4200, 7):
        big = rfft.layout(wl).p if melfft.fits(wl) else 0
        for step in sorted({0, 1, max(wl // 3, 1), wl, wl + 1}):
            err = lib.zt_irfft_ola_full(p, p, p, 1.0, 1, 0, wl, step, big,
                                        wl, 1, 1, 0)
            assert (err == 0) is (melfft.fits(wl) and 1 <= step <= wl), (
                wl, step, err)
    for wl, big in ((2048, 288), (441, 882), (262, 0), (2062, 2063),
                    (3093, 8194), (4078, 4076)):
        assert lib.zt_irfft_ola_full(p, p, p, 1.0, 1, 0, wl, wl // 2, big,
                                     wl, 1, 1, 0) != 0
    assert lib.zt_irfft_ola_full(p + 4, p, p, 1.0, 1, 0, 2048, 1024, 0,
                                 2048, 1, 1, 0) != 0


def test_irfft_entry_refuses_what_the_rule_refuses(dev):
    """The CUDA entry takes every length from 16 to 4,096 with its
    Bluestein length (rfft.layout(N).p) and a hop in [1, N], and refuses
    every other, and a wrong P, before any launch: T = 0 returns after the
    checks."""
    lib = _build.library()
    buf = torch.zeros(8192, device=dev)
    p = buf.data_ptr()
    for wl in range(1, 4200):
        big = rfft.layout(wl).p if melfft.fits(wl) else 0
        for step in sorted({0, 1, max(wl // 3, 1), wl, wl + 1}):
            err = lib.zt_irfft_ola(p, p, p, p, 1.0, 1, 0, wl, step, big, 0)
            assert (err == 0) is (melfft.fits(wl) and 1 <= step <= wl), (
                wl, step, err)
    for wl, big in ((2048, 288), (441, 882), (262, 0), (2062, 2063),
                    (3093, 8194), (4078, 4076)):
        assert lib.zt_irfft_ola(p, p, p, p, 1.0, 1, 0, wl, wl // 2, big,
                                0) != 0


def test_irfft_kernel_takes_an_hour_in_one_launch(dev):
    """One hour at 44.1 kHz, WL 2048 / hop 1024: 155,041 frames, 19,380
    blocks on grid x, in one launch; its first and last samples against
    the plain version of the frames that reach them."""
    wl, step, t = 2048, 1024, 155041
    gen = torch.Generator(device=dev).manual_seed(19)
    h_re, h_im = torch.randn((2, t, wl // 2 + 1), device=dev, generator=gen)
    before = irfft.istft_ola_fft.launches
    out = irfft.istft_ola_fft(h_re, h_im, wl, step, 0.5)
    assert irfft.istft_ola_fft.launches == before + 1
    assert out.shape == ((t - 1) * step + wl,)
    head = irfft.istft_ola_fft_plain(h_re[:64], h_im[:64], wl, step, 0.5)
    tail = irfft.istft_ola_fft_plain(h_re[-64:], h_im[-64:], wl, step, 0.5)
    assert torch.equal(out[:64 * step], head[:64 * step])
    assert torch.equal(out[(t - 64) * step + wl:], tail[wl:])


@pytest.mark.parametrize("wl", [2048, 1764, 1102, 2822, 262])
@pytest.mark.parametrize("dial", ["highest", "split4"])
def test_stft_istft_take_the_ffts_on_both_dials(dev, wl, dial, monkeypatch):
    """stft -> istft on the card: at every window from 16 to 4,096 (WL
    2048, 1764, through the odd-prime passes 1102 and 2822, by Bluestein
    262) both dials launch the FFT analysis and the inverse FFT synthesis,
    once each and no B4 or B4-s4, bit-equal across the dials, within 1e-5
    of max of the CPU float64 path and above 120 dB."""
    x64 = np.random.default_rng(wl + 3).standard_normal((2, 44100))
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    win = hamming(wl)
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    counters = {"full": irfft.istft_ola_fft_full, "fft": irfft.istft_ola_fft,
                "gemm": synth.istft_ola, "twin": synth.istft_ola_split4}
    before = {k: c.launches for k, c in counters.items()}
    spec = zaftpu_torch.stft(x, win, wl // 2)
    rec = zaftpu_torch.istft(spec, win, wl // 2)
    moved = {k for k, c in counters.items() if c.launches != before[k]}
    want = ("full" if irfft.applies(wl) else
            "twin" if dial == "split4" else "gemm")
    assert moved == {want} and counters[want].launches == before[want] + 1
    monkeypatch.setenv("ZAFTPU_PRECISION", "highest")
    ref = zaftpu_torch.istft(zaftpu_torch.stft(torch.from_numpy(x64), win,
                                               wl // 2), win, wl // 2)
    err = rec.cpu().double()[..., :x64.shape[-1]] - torch.from_numpy(x64)
    snr = 10 * np.log10((x64 ** 2).sum() / float((err ** 2).sum()))
    if want == "twin":
        assert 100.0 < snr < 125.0
        return
    assert torch.equal(rec, zaftpu_torch.istft(spec, win, wl // 2))
    assert _rel_err(rec.cpu().double(), ref) < 1e-5
    assert snr > 120.0


@pytest.mark.parametrize("dial", ["highest", "split4"])
@pytest.mark.parametrize("lever", [None, "matmul"])
def test_odd_window_takes_the_half_store_on_card(dev, dial, lever,
                                                monkeypatch):
    """An odd window: stft -> istft at WL 1323 / hop 441 (30 ms at 44.1
    kHz, periodic Hamming at a third of its length) under ZAFTPU_FULLSPEC=0
    launches the FFT kernel's half store (each frame a complex 1,323-point
    FFT) and the inverse FFT kernel's fused fold once each, and with
    ZAFTPU_FFT=matmul
    B1 and B4 (their twins under split4); the spectrum and the signal
    within 1e-5 (1e-4 where a twin runs) of max of the CPU float64 path,
    the half store's spectrum bit-equal across the dials. (At an odd window
    the reference's trim leaves the round trip one sample off, so it is
    held to that path, not to x.)"""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    monkeypatch.setenv("ZAFTPU_FULLSPEC", "0")
    if lever is not None:
        monkeypatch.setenv("ZAFTPU_FFT", lever)
    wl, step = 1323, 441
    x64 = np.random.default_rng(wl).standard_normal((2, 44100))
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    win = hamming(wl)
    counters = {"gemm": fused.frames_rfft, "twin": fused.frames_rfft_split4,
                "synth": synth.istft_ola, "synth_twin": synth.istft_ola_split4,
                "fft": rfft.frames_rfft_fft,
                "fft_full": rfft.frames_rfft_full_fft,
                "ifft": irfft.istft_ola_fft,
                "ifft_full": irfft.istft_ola_fft_full}
    before = {k: c.launches for k, c in counters.items()}
    spec = zaftpu_torch.stft(x, win, step)
    rec = zaftpu_torch.istft(spec, win, step)
    moved = {k for k, c in counters.items() if c.launches != before[k]}
    analysis = "fft" if lever is None else (
        "twin" if dial == "split4" else "gemm")
    synthesis = "ifft_full" if lever is None else (
        "synth_twin" if dial == "split4" else "synth")
    want = {analysis, synthesis}
    assert moved == want
    assert all(counters[k].launches == before[k] + 1 for k in want)
    monkeypatch.setenv("ZAFTPU_PRECISION", "highest")
    if lever is None:
        assert torch.equal(spec, zaftpu_torch.stft(x, win, step))
    monkeypatch.delenv("ZAFTPU_FFT", raising=False)
    oracle = zaftpu_torch.stft(torch.from_numpy(x64), win, step)
    tol = 1e-4 if dial == "split4" and lever else 1e-5
    spec_tol = 1e-5 if analysis == "fft" else tol
    assert _rel_err(spec.cpu().to(torch.complex128), oracle) < spec_tol
    assert _rel_err(rec.cpu().double(),
                    zaftpu_torch.istft(oracle, win, step)) < tol


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


def test_irfft_kernel_returns_zeros_for_no_frames(dev):
    """With no frames the wrapper returns its plain version's N - step
    zeros a row, not an unwritten buffer, and launches nothing."""
    wl, step = 2048, 512
    for lead in ((), (2, 3)):
        # A buffer that held other values, so stale memory would show.
        junk = torch.full((1 << 16,), 7.0, device=dev)
        del junk
        h = torch.zeros((*lead, 0, wl // 2 + 1), device=dev)
        before = irfft.istft_ola_fft.launches
        got = irfft.istft_ola_fft(h, h, wl, step, 0.5)
        assert irfft.istft_ola_fft.launches == before
        ref = irfft.istft_ola_fft_plain(h, h, wl, step, 0.5)
        assert got.shape == ref.shape == (*lead, wl - step)
        assert torch.equal(got, ref) and not got.any()


# The fast MDCT and IMDCT + overlap-add kernels: B2, B7 and their twins at
# every window that is a multiple of 4 up to 4096 whose quarter has no
# prime factor above 127.

MDCT_FFT_SHAPES = [(2048, 37), (2048, 1), (2048, 2), (256, 61), (32, 300),
                   (64, 257), (4096, 9), (1024, 5),
                   # Odd primes in the quarter: 1100 (5, 5, 11), 1764 (3,
                   # 3, 7, 7), 2060 (5, 103), 4088 (2, 2, 2, 7, 73), 1920
                   # (2^5, 3, 5), 508 (127), 1196 (13, 23: two register
                   # primes), 572 (11, 13: a prime first, then another).
                   (1100, 23), (1764, 9), (2060, 7), (4088, 5), (1920, 11),
                   (508, 40), (1196, 19), (572, 31)]


@pytest.mark.parametrize("wl,t", MDCT_FFT_SHAPES)
@pytest.mark.parametrize("lead,offset", [((), 0), ((2, 3), 0), ((), 1),
                                         ((2,), 3)])
def test_mdct_fft_kernels_match_plain(dev, wl, t, lead, offset):
    """Both kernels bit-equal to their plain versions, which do the
    kernels' float32 operations in their order, and within 2e-6 of max of
    the float64 path: batched, misaligned (a signal and coefficients that
    start 1 or 3 floats past an aligned address), T = 1 and 2."""
    f = wl // 2
    rng = np.random.default_rng(wl + t + offset)
    n = (t + 1) * f
    flat = torch.from_numpy(rng.standard_normal(
        int(np.prod(lead, dtype=np.int64)) * n + offset).astype(
            np.float32)).to(dev)
    padded = flat[offset:].reshape(*lead, n)
    win = torch.from_numpy(vorbis(wl).astype(np.float32)).to(dev)
    before = kmdct.mdct_fft.launches
    got = kmdct.mdct_fft(padded, win, wl, t)
    assert kmdct.mdct_fft.launches == before + 1
    ref = kmdct.mdct_fft_plain(padded, win, wl, t)
    assert got.shape == ref.shape == (*lead, t, f)
    assert torch.equal(got, ref), _rel_err(got, ref)
    oracle = kmdct.mdct_fft(padded.cpu().double(), win.cpu().double(), wl, t)
    assert _rel_err(got.cpu().double(), oracle) < 2e-6

    cflat = torch.zeros(got.numel() + offset, device=dev)
    cflat[offset:] = got.reshape(-1)
    coeffs = cflat[offset:].view(got.shape)
    wb = vorbis(wl).tobytes()
    before = kmdct.imdct_ola_fft.launches
    rec = kmdct.imdct_ola_fft(coeffs, f, wb)
    assert kmdct.imdct_ola_fft.launches == before + 1
    rref = kmdct.imdct_ola_fft_plain(coeffs, f, wb)
    assert rec.shape == rref.shape == (*lead, (t + 1) * f)
    assert torch.equal(rec, rref), _rel_err(rec, rref)
    oracle = kmdct.imdct_ola_fft(coeffs.cpu().double(), f, wb)
    assert _rel_err(rec.cpu().double(), oracle) < 2e-6


def test_mdct_fft_kernels_repeat_at_the_main_path_shape(dev):
    """Each kernel run twice on the same input at the main-path shape
    (vorbis 2048, a 600-s segment: T 25,841) gives the same bits twice:
    every output is written once, with no atomics and no order that
    changes from run to run."""
    wl, t = 2048, 25841
    f = wl // 2
    rng = np.random.default_rng(2048)
    padded = torch.from_numpy(rng.standard_normal((t + 1) * f).astype(
        np.float32)).to(dev)
    win = torch.from_numpy(vorbis(wl).astype(np.float32)).to(dev)
    before = kmdct.mdct_fft.launches
    first = kmdct.mdct_fft(padded, win, wl, t)
    second = kmdct.mdct_fft(padded, win, wl, t)
    assert kmdct.mdct_fft.launches == before + 2
    assert torch.equal(first, second)
    wb = vorbis(wl).tobytes()
    before = kmdct.imdct_ola_fft.launches
    rec = kmdct.imdct_ola_fft(first, f, wb)
    again = kmdct.imdct_ola_fft(first, f, wb)
    assert kmdct.imdct_ola_fft.launches == before + 2
    assert rec.shape == again.shape == ((t + 1) * f,)
    assert torch.equal(rec, again)


def test_imdct_ola_fft_returns_zeros_for_no_frames(dev):
    """No frames: F zeros a row, as its plain version and B7 return, and no
    launch, not an unwritten buffer."""
    f = 1024
    wb = vorbis(2 * f).tobytes()
    for lead in ((), (2, 3)):
        c = torch.zeros((*lead, 0, f), device=dev)
        before = kmdct.imdct_ola_fft.launches
        got = kmdct.imdct_ola_fft(c, f, wb)
        assert kmdct.imdct_ola_fft.launches == before
        ref = kmdct.imdct_ola_fft_plain(c, f, wb)
        assert got.shape == ref.shape == (*lead, f)
        assert torch.equal(got, ref) and not got.any()


def test_mdct_fft_entries_take_exactly_what_fits_takes(dev):
    """Both CUDA entries take exactly the window lengths mdct.fits takes
    and refuse every other before any launch: T = 0 returns after the
    checks."""
    lib = _build.library()
    buf = torch.zeros(8192, device=dev)
    p = buf.data_ptr()
    for wl in range(1, 4200):
        err = lib.zt_mdct_fft(p, p, p, p, p, 1, 8192, 0, wl, 0)
        assert (err == 0) is kmdct.fits(wl), (wl, err)
        err = lib.zt_imdct_ola_fft(p, p, p, p, p, 1, 0, wl, 0)
        assert (err == 0) is kmdct.fits(wl), (wl, err)


@pytest.mark.parametrize("wl", [2048, 1100, 1102, 524])
@pytest.mark.parametrize("dial", ["highest", "split4"])
def test_mdct_imdct_take_the_fast_kernels_on_both_dials(dev, wl, dial,
                                                        monkeypatch):
    """mdct -> imdct on the card: where the MDCT rule holds (WL 2048, and
    1100 through the odd-prime pass) both dials launch the fast MDCT and
    IMDCT kernels, once each and no B2, B7 or twin, bit-equal across the
    dials, within 1e-5 of max of the CPU float64 path and above 120 dB; at
    WL 1102 (F odd) and 524 (quarter 131) B2 and B7 run (their twins under
    split4, then in split4's band)."""
    x64 = np.random.default_rng(wl + 5).standard_normal((2, 44100))
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    win = vorbis(wl)
    ref = zaftpu_torch.mdct(torch.from_numpy(x64), win)
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    counters = {"fft": (kmdct.mdct_fft, kmdct.imdct_ola_fft),
                "gemm": (fused.frames_op, synth.imdct_ola),
                "twin": (fused.frames_op_split4, synth.imdct_ola_split4)}
    before = {k: [c.launches for c in cs] for k, cs in counters.items()}
    coeffs = zaftpu_torch.mdct(x, win)
    rec = zaftpu_torch.imdct(coeffs, win)
    moved = {k for k, cs in counters.items()
             if [c.launches for c in cs] != before[k]}
    ran = ("fft" if kmdct.fits(wl)
           else "twin" if dial == "split4" else "gemm")
    assert moved == {ran}
    assert [c.launches for c in counters[ran]] == [b + 1 for b in before[ran]]
    assert _rel_err(coeffs.cpu().double(), ref) < (
        1e-4 if ran == "twin" else 1e-5)
    err = rec.cpu().double()[..., :x64.shape[-1]] - torch.from_numpy(x64)
    snr = 10 * np.log10((x64 ** 2).sum() / float((err ** 2).sum()))
    if ran == "twin":
        assert 100.0 < snr < 125.0
    else:
        assert snr > 120.0
    if ran == "fft":
        monkeypatch.setenv("ZAFTPU_PRECISION", "highest")
        assert torch.equal(coeffs, zaftpu_torch.mdct(x, win))
        assert torch.equal(rec, zaftpu_torch.imdct(coeffs, win))


# The real-FFT kernel's magnitude and mel stores: B8, B9 and B9-s4's
# function at every window rfft.fits takes.

MELFFT_SHAPES = [(16, 5), (400, 160), (1102, 551), (2032, 1000),
                 (2662, 1331), (2822, 1411), (2048, 1024), (4096, 256)]
# The stores at windows rfft.fits refuses, one of each path: an odd N a
# complex FFT a frame in the static block (441) and in the dynamic one
# (2,205),
# Bluestein with an even N (262: P 288 in the static block; 2,062: P 2,304
# and 4,078: P 4,096 in the 4,096-value block) and with an odd N (131: P 288;
# 1,031: P 2,304; 3,093: P 6,400 in the 8,192-value block).
MELFFT_ANY_SHAPES = [(441, 147), (2205, 441), (262, 100), (2062, 512),
                     (4078, 1024), (131, 50), (1031, 400), (3093, 1000)]


def _filterbanks(wl):
    """(name, dense (n_mels, WL//2) float64) for the stores' card tests: 1,
    40, 128 and 800 random sparse rows (about a tenth nonzero, rows of
    zeros among them) and a dense random one."""
    rng = np.random.default_rng(wl)
    out = []
    for mels in (1, 40, 128, 800):
        fb = rng.random((mels, wl // 2))
        fb[rng.random(fb.shape) < 0.9] = 0.0
        out.append((f"{mels} sparse", fb))
    out.append(("dense", rng.standard_normal((24, wl // 2))))
    return out


@pytest.mark.parametrize("wl,step", MELFFT_SHAPES + MELFFT_ANY_SHAPES)
@pytest.mark.parametrize("t", [0, 1, 2, 1001])
@pytest.mark.parametrize("lead,offset", [((), 0), ((3,), 1)])
def test_melfft_stores_match_plain(dev, wl, step, t, lead, offset):
    """Both stores bit-equal to their plain versions (torch.equal), batched
    and misaligned, with 1 to 800 mels and a dense foreign filterbank,
    magnitude and power, at the rule's windows and on every path off it (T
    1 and 1,001: a block's last rows empty); zero frames give an empty
    output and no launch."""
    padded, win = _inputs(wl, step, max(t, 1), dev, lead, offset)
    before = (melfft.spec_rows_fft.launches, melfft.mel_rows_fft.launches)
    spec = melfft.spec_rows_fft(padded, win, wl, step, t)
    assert spec.shape == (*lead, t, wl // 2) and spec.is_cuda
    if t:
        assert torch.equal(spec, melfft.spec_rows_fft_plain(padded, win, wl,
                                                            step, t))
    for name, fb in _filterbanks(wl):
        table = melfft.device_table(melfft.filterbank_table(fb), dev)
        for power in (False, True):
            got = melfft.mel_rows_fft(padded, win, table, wl, step, t, power)
            assert got.shape == (*lead, t, fb.shape[0]), name
            if t:
                ref = melfft.mel_rows_fft_plain(padded, win, table, wl, step,
                                                t, power)
                assert torch.equal(got, ref), (name, power)
    runs = 1 if t else 0
    assert (melfft.spec_rows_fft.launches, melfft.mel_rows_fft.launches) == (
        before[0] + runs, before[1] + 10 * runs)


@pytest.mark.parametrize("wl,step", MELFFT_SHAPES)
def test_magnitude_store_is_the_half_stores_bins(dev, wl, step):
    """The magnitude store equals sqrt(re*re + im*im) of the half store's
    bins 1..WL/2 (torch's products, sum and correctly rounded root on the
    card), bit for bit."""
    padded, win = _inputs(wl, step, 301, dev, (2,), 1)
    half = rfft.frames_rfft_fft(padded, win, wl, step, 301)[..., 1:]
    re, im = half.real, half.imag
    want = torch.sqrt((re * re + im * im).double()).float()
    assert torch.equal(melfft.spec_rows_fft(padded, win, wl, step, 301), want)


def test_melfft_entries_take_exactly_what_fits_takes(dev):
    """The two C entries take exactly the lengths melfft.fits takes (16 to
    4,096), each with its Bluestein length (rfft.layout(WL).p, 0 where the
    passes take the FFT's own length), and refuse every other length and a
    wrong P before any launch (T = 0 returns after the checks); the mel
    entry refuses n_mels < 1 too; the wrappers raise ValueError on the
    same lengths."""
    lib = _build.library()
    buf = torch.zeros(8192, device=dev)
    ints = torch.zeros(8, dtype=torch.int32, device=dev)
    p = buf.data_ptr()
    for wl in range(1, 4200):
        big = rfft.layout(wl).p if melfft.fits(wl) else 0
        err = lib.zt_rfft_spec(p, p, p, p, 1, 8192, 0, wl, 1, big, 0)
        assert (err == 0) is melfft.fits(wl), (wl, err)
        err = lib.zt_rfft_mel(p, p, p, ints.data_ptr(), ints.data_ptr(), p,
                              p, 1, 8192, 0, wl, 1, big, 1, 0, 0)
        assert (err == 0) is melfft.fits(wl), (wl, err)
    assert lib.zt_rfft_mel(p, p, p, ints.data_ptr(), ints.data_ptr(), p, p,
                           1, 8192, 0, 2048, 1, 0, 0, 0, 0) != 0
    # P: none at a length the passes take; under Bluestein at least 2M - 1,
    # free of primes above 127, at most 8,192, its passes opening with two
    # radix-4 ones (the first step the Bluestein kernels build) and holding
    # no prime from 11 to 31 (they have no register-prime variant): 261 =
    # 3^2 29 and 272 = 2^4 17 are refused, 592 = 2^4 37 taken.
    for wl, big in ((2048, 288), (441, 882), (262, 0), (262, 260),
                    (262, 262), (2062, 2063), (3093, 8194), (262, 261),
                    (262, 272)):
        assert lib.zt_rfft_spec(p, p, p, p, 1, 8192, 0, wl, 1, big, 0) != 0
    for wl, big in ((262, 592), (262, 2048), (3093, 8192)):
        assert lib.zt_rfft_spec(p, p, p, p, 1, 8192, 0, wl, 1, big, 0) == 0
    for wl in (15, 4097):
        padded, win = _inputs(wl, wl // 2, 3, dev)
        table = melfft.device_table(melfft.filterbank_table(
            np.ones((2, wl // 2))), dev)
        with pytest.raises(ValueError, match="must be in"):
            melfft.spec_rows_fft(padded, win, wl, wl // 2, 3)
        with pytest.raises(ValueError, match="must be in"):
            melfft.mel_rows_fft(padded, win, table, wl, wl // 2, 3, False)


# One window of each path rfft_any and the static path take, by block
# (2,048 / 4,096 / 8,192 values), layout (odd, even, Bluestein) and the
# radices of its plan (rfft.radices of N, N/2 or P): the static path's
# ends (16, 4,096) and halves of radix 127 (254) and 23 x 89 (4,094); odd
# N with radices 17 (17, 255), 19 x 29 (551), 23 x 89 (2,047), 127 (127),
# 3 and 7 (441) and in the 4,096-value block 13 (4,095), 5 and 7 (2,205),
# 5 only (3,125), 59 (3,481); Bluestein with an even N (262: P 288, 514:
# P 576, 2,062: P 2,304, 4,078: P 4,096) and an odd N (131: P 288, 393: P
# 800, 1,031: P 2,304, 2,039: P 4,096, and in the 8,192-value block 2,049:
# P 4,608, 3,093: P 6,400, 4,093: P 8,192).
EVERY_PATH_WINDOWS = [16, 254, 4096, 17, 255, 551, 2047, 127, 441, 4095,
                      2205, 3125, 3481, 262, 514, 2062, 4078, 4094, 131, 393,
                      1031, 2039, 2049, 3093, 4093]


def _spec_store_bit_equal(dev, wl):
    """The magnitude store at ``wl`` launches once and equals its plain
    version bit for bit: 3 frames, 2 rows, a hop that does not divide the
    window, misaligned."""
    before = melfft.spec_rows_fft.launches
    step = wl // 3 + 1
    padded, win = _inputs(wl, step, 3, dev, (2,), 1)
    got = melfft.spec_rows_fft(padded, win, wl, step, 3)
    assert torch.equal(got, melfft.spec_rows_fft_plain(padded, win, wl,
                                                       step, 3)), wl
    assert melfft.spec_rows_fft.launches == before + 1


@pytest.mark.parametrize("wl", EVERY_PATH_WINDOWS)
def test_spec_store_takes_every_window_bit_equal(dev, wl):
    """EVERY_PATH_WINDOWS through _spec_store_bit_equal; every window from
    16 to 4,096 with ZAFTPU_CUDA_SWEEP=1 (the test below)."""
    _spec_store_bit_equal(dev, wl)


def _half_stores_bit_equal(dev, wl, step, t, lead=(2,), offset=1):
    """The half and planes stores at ``wl`` launch once each (nothing for
    zero frames) and equal their plain versions bit for bit, the planes
    the half store's values: batched and misaligned by default."""
    padded, win = _inputs(wl, step, max(t, 1), dev, lead, offset)
    before = (rfft.frames_rfft_fft.launches, rfft.frames_matmul2_fft.launches)
    half = rfft.frames_rfft_fft(padded, win, wl, step, t)
    re, im = rfft.frames_matmul2_fft(padded, win, wl, step, t)
    assert half.shape == re.shape == im.shape == (*lead, t, wl // 2 + 1)
    assert half.dtype == torch.complex64 and half.is_cuda
    if t:
        args = (padded, win, wl, step, t)
        assert torch.equal(half, rfft.frames_rfft_fft_plain(*args)), wl
        pre, pim = rfft.frames_matmul2_fft_plain(*args)
        assert torch.equal(re, pre) and torch.equal(im, pim), wl
        assert torch.equal(torch.complex(re, im), half), wl
    runs = 1 if t else 0
    assert (rfft.frames_rfft_fft.launches,
            rfft.frames_matmul2_fft.launches) == (before[0] + runs,
                                                  before[1] + runs)


# The static path's steps (csrc/stockham.cuh: static_plan) at each power
# of two from 16 to 4,096 (radix-16 steps: none at 16 (4 then 2), one at
# 32 and 128 (plus a radix-2 or radix-4 step), two at 512 and 2,048), the
# paired radix-3 passes (18: M 9; 1,764: 2, 3 3, 7, 7; 1,458: M 729),
# mixed radices (400), and primes above 7: 11 (22, 88), 29 (1,102: 19 then
# 29), 31 (62, 248), 37 (296), 127 (254, 2,032), three 11s (2,662) and 83
# (2,822), each with its input twiddles applied by the step before.
STATIC_WINDOWS = [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 18, 1764,
                  1458, 400, 22, 88, 1102, 62, 248, 296, 254, 2032, 2662,
                  2822]


def _static_stores_bit_equal(dev, wl, step, t, lead, offset):
    """All five stores of the static path at ``wl`` equal their plain
    versions bit for bit (torch.equal), the mel store with a sparse
    filterbank, magnitude and power."""
    assert rfft.fits(wl)
    padded, win = _inputs(wl, step, t, dev, lead, offset)
    args = (padded, win, wl, step, t)
    assert torch.equal(rfft.frames_rfft_fft(*args),
                       rfft.frames_rfft_fft_plain(*args)), wl
    re, im = rfft.frames_matmul2_fft(*args)
    pre, pim = rfft.frames_matmul2_fft_plain(*args)
    assert torch.equal(re, pre) and torch.equal(im, pim), wl
    assert torch.equal(rfft.frames_rfft_full_fft(*args),
                       rfft.frames_rfft_full_fft_plain(*args)), wl
    assert torch.equal(melfft.spec_rows_fft(*args),
                       melfft.spec_rows_fft_plain(*args)), wl
    fb = np.random.default_rng(wl).random((13, wl // 2))
    fb[fb < 0.7] = 0.0
    table = melfft.device_table(melfft.filterbank_table(fb), dev)
    for power in (False, True):
        got = melfft.mel_rows_fft(padded, win, table, wl, step, t, power)
        ref = melfft.mel_rows_fft_plain(padded, win, table, wl, step, t,
                                        power)
        assert torch.equal(got, ref), (wl, power)


@pytest.mark.parametrize("wl", STATIC_WINDOWS)
@pytest.mark.parametrize("case", ["ragged", "aligned", "one frame"])
def test_static_stores_bit_equal(dev, wl, case):
    """STATIC_WINDOWS through _static_stores_bit_equal: T not a multiple of
    the frames a block takes, 2 rows, an odd hop and a signal one float
    off (scalar loads); one row at hop WL/2 (8-byte loads); one frame."""
    fpb = 2048 // (wl // 2)
    step, t, lead, offset = {
        "ragged": ((wl // 3) | 1, 2 * fpb + 1, (2,), 1),
        "aligned": (wl // 2, fpb + 1, (), 0),
        "one frame": (wl // 2, 1, (), 0)}[case]
    _static_stores_bit_equal(dev, wl, step, t, lead, offset)


@pytest.mark.parametrize("wl,step,t", [(400, 160, 1001), (1102, 441, 301),
                                       (16, 7, 257)])
def test_overlap_add_repeats_and_equals_plain(dev, wl, step, t):
    """At hops that do not divide the window the OLA kernel and the plain
    overlap-add (c ascending, no atomics) agree bit for bit, and two runs
    of each give the same bytes."""
    frames = torch.from_numpy(np.random.default_rng(wl).standard_normal(
        (3, t, wl)).astype(np.float32)).to(dev)
    got = [ola.overlap_add(frames, step) for _ in range(2)]
    ref = [ola.overlap_add_plain(frames, step) for _ in range(2)]
    for x in got[1:] + ref:
        assert torch.equal(x.view(torch.int32), got[0].view(torch.int32))


@pytest.mark.skipif(os.environ.get("ZAFTPU_CUDA_SWEEP") != "1",
                    reason="the sweep of all 4,081 windows takes several "
                    "minutes on an H100; set ZAFTPU_CUDA_SWEEP=1")
def test_spec_store_every_window_sweep(dev):
    """Every window from 16 to 4,096 through _spec_store_bit_equal and,
    for the half and planes stores, _half_stores_bit_equal, for the full
    store and the inverse kernel _full_and_inverse (3 frames, a hop that
    does not divide the window)."""
    for wl in range(16, 4097):
        _spec_store_bit_equal(dev, wl)
        _half_stores_bit_equal(dev, wl, wl // 3 + 1, 3)
        _full_and_inverse(dev, wl, wl // 3 + 1, 3)


# The half and planes stores at every window from 16 to 4,096 (B1's and
# B12's function, and B1-s4's and B12-s4's off the full store's rule):
# tests/test_torch_rfft_any.py's ORACLE_WINDOWS (the layouts and the ends)
# and EVERY_PATH_WINDOWS.
HALF_WINDOWS = sorted({16, 17, 131, 255, 262, 393, 441, 551, 1031, 1323,
                       2039, 2048, 2062, 2205, 3093, 4078, 4095, 4096,
                       *EVERY_PATH_WINDOWS})
# Ragged shapes in each block: the 2,048-value block (441: four rows; 262:
# Bluestein at P 288), the 4,096-value one (2,205; 2,062 and 4,078 by
# Bluestein at P 2,304 and 4,096) and the 8,192-value one (chip_smoke's
# ANY_RAGGED: 3,093 by Bluestein at P 6,400); odd T, hops that do not
# divide the window.
HALF_RAGGED = [(441, 100, 1001), (262, 100, 1001), (2205, 441, 301),
               (2062, 512, 301), (4078, 1000, 301), (3093, 1000, 301)]


@pytest.mark.parametrize("wl", HALF_WINDOWS)
def test_half_and_planes_stores_take_every_window_bit_equal(dev, wl):
    """HALF_WINDOWS through _half_stores_bit_equal: 3 frames, 2 rows, a
    hop that does not divide the window, misaligned."""
    _half_stores_bit_equal(dev, wl, wl // 3 + 1, 3)


@pytest.mark.parametrize("wl,step,t", HALF_RAGGED)
@pytest.mark.parametrize("lead,offset", [((), 0), ((3,), 1)])
def test_half_and_planes_stores_ragged_bit_equal(dev, wl, step, t, lead,
                                                 offset):
    """HALF_RAGGED's shapes, one row aligned and three misaligned, through
    _half_stores_bit_equal; within 2e-6 of max of the float64 oracle."""
    _half_stores_bit_equal(dev, wl, step, t, lead, offset)
    padded, win = _inputs(wl, step, t, dev, lead, offset)
    half = rfft.frames_rfft_fft(padded, win, wl, step, t)
    oracle = _oracle_half(padded, win, wl, step, t)
    assert _rel_err(half.cpu().to(torch.complex128), oracle) < 2e-6


@pytest.mark.parametrize("wl", [441, 2062, 3093, 2048])
def test_half_and_planes_stores_launch_nothing_for_zero_frames(dev, wl):
    """Zero frames: empty outputs and no launch, on every path (the static
    one at 2,048) and through frames_rfft / frames_matmul2."""
    _half_stores_bit_equal(dev, wl, wl // 2, 0)
    padded, win = _inputs(wl, wl // 2, 1, dev)
    before = (rfft.frames_rfft_fft.launches, rfft.frames_matmul2_fft.launches)
    assert fused.frames_rfft(padded, win, wl, wl // 2, 0).shape == (
        0, wl // 2 + 1)
    assert fused.frames_matmul2(padded, win, wl, wl // 2, 0)[0].shape == (
        0, wl // 2 + 1)
    assert (rfft.frames_rfft_fft.launches,
            rfft.frames_matmul2_fft.launches) == before


def _full_and_inverse(dev, wl, step, t, lead=(2,), offset=1):
    """The full store, the inverse kernel and its fused fold at ``wl``
    launch once each (nothing for zero frames): the full store equals its
    plain version bit for bit and the half store's values mirrored, the
    inverse on the half store's planes copied to an offset view equals its
    plain version bit for bit, and the fused fold on the full spectrum
    equals its plain version and the inverse on the half store's planes
    (the fold of a conjugate mirror is the half spectrum), at every window
    from 16 to 4,096 (irfft_any off rfft.fits). Batched and misaligned by
    default."""
    padded, win = _inputs(wl, step, max(t, 1), dev, lead, offset)
    half = rfft.frames_rfft_fft(padded, win, wl, step, max(t, 1))[..., :t, :]
    flat = torch.zeros(2 * half.numel() + offset, device=dev)
    planes = flat[offset:].view(2, *half.shape)
    planes[0], planes[1] = half.real, half.imag
    before = (rfft.frames_rfft_full_fft.launches,
              irfft.istft_ola_fft.launches, irfft.istft_ola_fft_full.launches)
    full = rfft.frames_rfft_full_fft(padded, win, wl, step, t)
    out = irfft.istft_ola_fft(planes[0], planes[1], wl, step, 0.5)
    out_full = irfft.istft_ola_fft_full(full, wl, step, 0.5)
    assert torch.equal(out_full, irfft.istft_ola_fft_full_plain(
        full, wl, step, 0.5)), wl
    assert torch.equal(out_full, out), wl
    assert full.shape == (*lead, t, wl) and full.dtype == torch.complex64
    assert out.shape == (*lead, (t - 1) * step + wl) and out.is_cuda
    if t:
        args = (padded, win, wl, step, t)
        assert torch.equal(full, rfft.frames_rfft_full_fft_plain(*args)), wl
        assert torch.equal(full, tfft.conjugate_mirror(half, wl)), wl
        ref = irfft.istft_ola_fft_plain(planes[0], planes[1], wl, step, 0.5)
        assert torch.equal(out, ref), (wl, _rel_err(out, ref))
    else:
        assert not out.any()
    runs = 1 if t else 0
    assert (rfft.frames_rfft_full_fft.launches, irfft.istft_ola_fft.launches,
            irfft.istft_ola_fft_full.launches) == (
                before[0] + runs, before[1] + runs, before[2] + runs)


@pytest.mark.parametrize("wl", HALF_WINDOWS)
def test_full_store_and_inverse_take_every_window(dev, wl):
    """HALF_WINDOWS through _full_and_inverse: 3 frames, 2 rows, a hop
    that does not divide the window, misaligned."""
    _full_and_inverse(dev, wl, wl // 3 + 1, 3)


@pytest.mark.parametrize("wl,step,t", HALF_RAGGED)
@pytest.mark.parametrize("hop", ["1", "ragged", "whole"])
@pytest.mark.parametrize("lead,offset", [((), 0), ((3,), 1)])
def test_full_store_and_inverse_ragged(dev, wl, step, t, hop, lead, offset):
    """HALF_RAGGED's shapes at a hop of 1, the shape's own (not dividing
    the window) and N, one row aligned and three misaligned, through
    _full_and_inverse; the inverse within 2e-6 of max of its float64 plain
    version on the CPU."""
    step = {"1": 1, "ragged": step, "whole": wl}[hop]
    _full_and_inverse(dev, wl, step, t, lead, offset)
    padded, win = _inputs(wl, step, t, dev, lead, offset)
    half = rfft.frames_rfft_fft(padded, win, wl, step, t)
    out = irfft.istft_ola_fft(half.real.contiguous(),
                              half.imag.contiguous(), wl, step, 0.5)
    oracle = irfft.istft_ola_fft(half.real.cpu().double(),
                                 half.imag.cpu().double(), wl, step, 0.5)
    assert _rel_err(out.cpu().double(), oracle) < 2e-6


@pytest.mark.parametrize("wl", [441, 2062, 3093, 2048])
def test_full_store_and_inverse_launch_nothing_for_zero_frames(dev, wl):
    """Zero frames: an empty spectrum, the N - step zeros a row and no
    launch, on every path (the static one at 2,048) and through
    fused.frames_rfft_full / synth.istft_ola."""
    _full_and_inverse(dev, wl, wl // 2, 0)
    padded, win = _inputs(wl, wl // 2, 1, dev)
    h = torch.zeros((0, wl // 2 + 1), device=dev)
    before = (rfft.frames_rfft_full_fft.launches,
              irfft.istft_ola_fft.launches)
    assert fused.frames_rfft_full(padded, win, wl, wl // 2, 0).shape == (
        0, wl)
    out = synth.istft_ola(h, h, wl, wl // 2, 0.5)
    assert out.shape == (wl - wl // 2,) and not out.any()
    assert (rfft.frames_rfft_full_fft.launches,
            irfft.istft_ola_fft.launches) == before


@pytest.mark.parametrize("wl", [441, 1031, 2205, 3093, 262])
def test_inverse_silent_frames_exact_zero(dev, wl):
    """The inverse kernel on disjoint frames (hop N) whose planes are zero
    in frames 1, 2 and 5 gives exactly 0 in their samples (each frame its
    own FFT), and its plain version's values, bit for bit."""
    silent = torch.tensor([False, True, True, False, False, True, False])
    gen = torch.Generator(device=dev).manual_seed(wl)
    h = torch.randn((2, len(silent), wl // 2 + 1), device=dev, generator=gen)
    h[:, silent.to(dev)] = 0.0
    out = irfft.istft_ola_fft(h[0], h[1], wl, wl, 1.0)
    assert not out.view(len(silent), wl)[silent.to(dev)].any()
    ref = irfft.istft_ola_fft_plain(h[0], h[1], wl, wl, 1.0)
    assert torch.equal(out, ref), _rel_err(out, ref)


@pytest.mark.parametrize("wl", [3093, 4095, 2062])
def test_mel_store_every_bin_a_mel_at_the_largest_blocks(dev, wl):
    """The mel store with one mel a bin (1,546 at WL 3,093, the 8,192-value
    block; 2,047 at 4,095 and 1,031 at 2,062, the 4,096-value block: the
    largest free buffers), an identity and a dense random filterbank, power
    and magnitude: bit-equal to the plain version, and the identity's mels
    are the magnitude store's bins."""
    step, t = 1000, 301
    padded, win = _inputs(wl, step, t, dev, (2,), 1)
    f = wl // 2
    rng = np.random.default_rng(wl)
    spec = melfft.spec_rows_fft(padded, win, wl, step, t)
    for name, fb in (("identity", np.eye(f)),
                     ("dense", rng.standard_normal((f, f)))):
        table = melfft.device_table(melfft.filterbank_table(fb), dev)
        for power in (False, True):
            got = melfft.mel_rows_fft(padded, win, table, wl, step, t, power)
            assert torch.equal(got, melfft.mel_rows_fft_plain(
                padded, win, table, wl, step, t, power)), (name, power)
            if name == "identity" and not power:
                assert torch.equal(got, spec)


_ROUTE_COUNTERS = {"spec_rows_fft": melfft.spec_rows_fft,
                   "mel_rows_fft": melfft.mel_rows_fft,
                   "spec_rows": melfused.spec_rows,
                   "mel_rows": melfused.mel_rows,
                   "mel_rows_split4": melfused.mel_rows_split4,
                   "frames_rfft_fft": rfft.frames_rfft_fft,
                   "frames_rfft": fused.frames_rfft,
                   "frames_rfft_split4": fused.frames_rfft_split4}


@pytest.mark.parametrize("wl,melfuse,fft,want,want_split4", [
    (2048, None, None, {"spec_rows_fft", "mel_rows_fft"},
     {"spec_rows_fft", "mel_rows_fft"}),
    (1102, "1", None, {"spec_rows_fft", "mel_rows_fft"},
     {"spec_rows_fft", "mel_rows_fft"}),
    (2048, "0", None, {"frames_rfft_fft"}, {"frames_rfft_fft"}),
    (2062, None, None, {"spec_rows_fft", "mel_rows_fft"},
     {"spec_rows_fft", "mel_rows_fft"}),
    (2048, None, "matmul", {"spec_rows", "mel_rows"},
     {"frames_rfft_split4"}),
    (2062, "1", None, {"spec_rows_fft", "mel_rows_fft"},
     {"spec_rows_fft", "mel_rows_fft"}),
    (2048, "1", "matmul", {"spec_rows", "mel_rows"},
     {"spec_rows", "mel_rows_split4"}),
    (2062, "0", None, {"frames_rfft_fft"}, {"frames_rfft_fft"}),
    (1323, None, None, {"spec_rows_fft", "mel_rows_fft"},
     {"spec_rows_fft", "mel_rows_fft"}),
    (2062, None, "matmul", {"spec_rows", "mel_rows"},
     {"frames_rfft_split4"})])
@pytest.mark.parametrize("dial", ["highest", "split4"])
def test_mel_routes_launch_counts_on_card(dev, wl, melfuse, fft, want,
                                          want_split4, dial, monkeypatch):
    """spectrogram, melspectrogram and mfcc of a float32 card signal launch
    the kernels of their route (kernels/melfused.route) and no others, on
    both dials: the stores at every window from 16 to 4,096 (2,062 by
    Bluestein, 1,323 a complex FFT a frame) unless ZAFTPU_MELFUSE=0, B8 / B9
    (B9-s4) or the half spectrum under ZAFTPU_FFT=matmul."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    for name, value in (("ZAFTPU_MELFUSE", melfuse), ("ZAFTPU_FFT", fft)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    x = torch.from_numpy(np.random.default_rng(wl).standard_normal(
        (2, 22050)).astype(np.float32)).to(dev)
    win = hamming(wl)
    fb = zaftpu_torch.melfilterbank(44100, wl, 40)
    before = {k: c.launches for k, c in _ROUTE_COUNTERS.items()}
    calls = _calls()
    zaftpu_torch.spectrogram(x, win, wl // 2)
    zaftpu_torch.melspectrogram(x, win, wl // 2, fb)
    zaftpu_torch.mfcc(x, win, wl // 2, fb, 20)
    moved = {k for k, c in _ROUTE_COUNTERS.items()
             if c.launches != before[k]}
    assert moved == (want_split4 if dial == "split4" else want)
    assert _calls() == calls


def test_mel_store_takes_an_hour_in_one_launch(dev):
    """One hour at 44.1 kHz through melspectrogram at MelConfig(): 155,041
    frames in one launch of the mel store; its first and last 64 frames
    against the plain version of the same frames."""
    cfg = zaftpu_torch.MelConfig()
    gen = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn(3600 * 44100, device=dev, generator=gen)
    before = melfft.mel_rows_fft.launches
    mel = zaftpu_torch.melspectrogram(x, config=cfg).T
    assert melfft.mel_rows_fft.launches == before + 1
    assert mel.shape == (155041, 40)
    padded, t = centre_padded(x, 2048, 1024)
    win = torch.from_numpy(cfg.window_array().astype(np.float32)).to(dev)
    table = melfft.device_table(melfft.filterbank_table(cfg.filterbank()),
                                dev)
    span = 63 * 1024 + 2048
    for rows, start in ((mel[:64], 0), (mel[-64:], (t - 64) * 1024)):
        ref = melfft.mel_rows_fft_plain(padded[start:start + span], win,
                                        table, 2048, 1024, 64, False)
        assert torch.equal(rows, ref)


# The inverse real-FFT kernel's windowed store (Griffin-Lim's synthesis),
# the windows above 4,096, the DCT / DST and Griffin-Lim on the card.

# WL, hop, T: hops that divide WL and that do not, odd-prime passes, T 0,
# 1 and 2, one hour's worth of output spans at Tacotron's 24 kHz window.
WINDOW_STORE_SHAPES = [(2048, 512, 37), (1200, 300, 61), (512, 100, 1001),
                       (400, 160, 2), (256, 64, 1), (256, 64, 0),
                       (254, 7, 300), (2822, 1411, 9), (16, 5, 3000)]


def _window_store_inputs(wl, step, t, lead, dev, offset=0):
    """The complex half spectrum (misaligned by ``offset`` complex values),
    the window and the floored envelope."""
    rng = np.random.default_rng(wl + step + t)
    f = wl // 2 + 1
    flat = rng.standard_normal(2 * int(np.prod(lead, dtype=int)) * t * f
                               + 2 * offset).astype(np.float32)
    spec = torch.view_as_complex(torch.from_numpy(flat).view(-1, 2)).to(
        dev)[offset:].view(*lead, t, f)
    win = torch.from_numpy(hamming(wl).astype(np.float32)).to(dev)
    wsq = ola.overlap_add((win * win).expand(max(t, 1), wl), step)
    wsq = wsq[:(t - 1) * step + wl].clamp_min(1e-12)
    return spec, win, wsq


@pytest.mark.parametrize("wl,step,t", WINDOW_STORE_SHAPES)
@pytest.mark.parametrize("lead,offset", [((), 0), ((2, 3), 1)])
def test_window_store_matches_plain(dev, wl, step, t, lead, offset):
    """Bit-equal to its plain version (batched, a misaligned complex
    spectrum, ragged hops, T 0, 1 and 2), one launch (none with no
    frames), within 2e-6 of max of the float64 plain version."""
    spec, win, wsq = _window_store_inputs(wl, step, t, lead, dev, offset)
    before = irfft.istft_ola_fft_window.launches
    got = irfft.istft_ola_fft_window(spec, wl, step, win, wsq)
    assert irfft.istft_ola_fft_window.launches == before + (t > 0)
    ref = irfft.istft_ola_fft_window_plain(spec, wl, step, win, wsq)
    assert got.shape == ref.shape == (*lead, (t - 1) * step + wl)
    assert torch.equal(got, ref), _rel_err(got, ref)
    if t:
        oracle = irfft.istft_ola_fft_window_plain(
            spec.cpu().to(torch.complex128), wl, step, win.cpu().double(),
            wsq.cpu().double())
        assert _rel_err(got.cpu().double(), oracle) < 2e-6


def test_window_store_leaves_the_existing_store(dev):
    """The existing store's values are its plain version's, bit for bit,
    beside the windowed one (one template, two stores)."""
    spec, win, wsq = _window_store_inputs(2048, 512, 37, (), dev)
    s_re, s_im = spec.real.contiguous(), spec.imag.contiguous()
    got = irfft.istft_ola_fft(s_re, s_im, 2048, 512, 0.5)
    assert torch.equal(got, irfft.istft_ola_fft_plain(s_re, s_im, 2048, 512,
                                                      0.5))


def test_window_store_entry_refuses_what_the_rule_refuses(dev):
    lib = _build.library()
    buf = torch.zeros(8192, device=dev)
    p = buf.data_ptr()
    for wl in range(1, 4200, 7):
        for step in sorted({0, 1, max(wl // 3, 1), wl, wl + 1}):
            err = lib.zt_irfft_ola_window(p, p, p, p, p, 1.0, 1, 0, wl,
                                          step, 0)
            assert (err == 0) is (rfft.fits(wl) and 1 <= step <= wl), (
                wl, step, err)


LONG_WINDOWS = [4098, 5000, 8192]


@pytest.mark.parametrize("wl", LONG_WINDOWS)
@pytest.mark.parametrize("dial", ["highest", "split4"])
@pytest.mark.parametrize("lever", ["auto", "matmul"])
def test_long_windows_on_the_card(dev, wl, dial, lever, monkeypatch):
    """stft, istft, spectrogram, melspectrogram, mfcc, mdct and imdct above
    4,096 on both dials, on torch.fft and under ZAFTPU_FFT=matmul (the
    four-step engine at 8,192): the framing and OLA kernels launch, no FFT
    or GEMM kernel does; the outputs within 1e-5 * max of the CPU float64
    path (MFCC atol 5e-3) and the round trips above 120 dB."""
    monkeypatch.setenv("ZAFTPU_PRECISION", dial)
    monkeypatch.setenv("ZAFTPU_FFT", lever)
    gen = torch.Generator(device=dev).manual_seed(wl)
    x = torch.randn(8 * wl + 17, device=dev, generator=gen)
    win, step = hamming(wl), wl // 2
    fb = zaftpu_torch.melfilterbank(44100, wl, 40)
    kernels = (framing.frame_window, ola.overlap_add, fused.frames_rfft,
               rfft.frames_rfft_fft, rfft.frames_rfft_full_fft,
               irfft.istft_ola_fft, irfft.istft_ola_fft_full, synth.istft_ola,
               kmdct.mdct_fft,
               kmdct.imdct_ola_fft, melfft.spec_rows_fft,
               melfft.mel_rows_fft, melfused.spec_rows, melfused.mel_rows)
    before = [k.launches for k in kernels]

    def run(a):
        spec = zaftpu_torch.stft(a, win, step)
        coeffs = zaftpu_torch.mdct(a, vorbis(wl))
        return {"stft": spec, "istft": zaftpu_torch.istft(spec, win, step),
                "spectrogram": zaftpu_torch.spectrogram(a, win, step),
                "melspectrogram": zaftpu_torch.melspectrogram(a, win, step,
                                                              fb),
                "mfcc": zaftpu_torch.mfcc(a, win, step, fb, 20),
                "mdct": coeffs, "imdct": zaftpu_torch.imdct(coeffs,
                                                            vorbis(wl))}

    got = run(x)
    moved = [k.launches - b for k, b in zip(kernels, before)]
    assert moved[:2] == [5, 2] and not any(moved[2:]), moved
    ref = run(x.cpu().double())
    for name, value in got.items():
        assert value.is_cuda, name
        if name == "mfcc":
            assert float((value.cpu().double() - ref[name]).abs().max()) < 5e-3
        else:
            assert _rel_err(value.cpu().to(ref[name].dtype), ref[name]) < 1e-5
    n = x.shape[-1]
    for rec in (got["istft"], got["imdct"]):
        err = rec[:n].double() - x.double()
        assert 10 * torch.log10((x.double() ** 2).sum()
                                / (err ** 2).sum()) > 120


@pytest.mark.parametrize("route", ["entry", "embedded", "embedded matmul"])
@pytest.mark.parametrize("n", [1024, 777, 4100, 8192])
def test_dct_dst_on_the_card(dev, route, n, monkeypatch):
    """All eight transforms on CUDA float32 against their CPU float64
    values within 1e-5 * max: the entry points (the (N, N) operator up to
    4,096, the embedded FFTs past it), or the embedded cores at every N
    (the direct GEMM rfft up to 4,096 and torch.fft past it; under
    ZAFTPU_FFT=matmul the four-step engine at powers of two); the inverse
    pairs."""
    if route == "embedded matmul":
        monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(3, n, device=dev, generator=gen)
    for entry, core in ((zaftpu_torch.dct, tdct._dct_core),
                        (zaftpu_torch.dst, tdct._dst_core)):
        fn = entry if route == "entry" else core
        for ttype in (1, 2, 3, 4):
            got = fn(x, ttype)
            assert got.is_cuda and got.dtype == torch.float32
            assert _rel_err(got.cpu().double(),
                            entry(x.cpu().double(), ttype)) < 1e-5
        for fwd, inv in ((1, 1), (2, 3), (4, 4)):
            assert _rel_err(fn(fn(x, fwd), inv).cpu().double(),
                            x.cpu().double()) < 1e-5


@pytest.mark.parametrize("wl,step", [(2048, 512), (1200, 300), (262, 131),
                                     (8192, 2048)])
def test_griffin_lim_on_the_card(dev, wl, step):
    """Each iteration launches the half store once at every window up to
    4,096 (rfft_any off the FFT rule; above 4,096 the framing kernel), and
    at the FFT rule's windows the windowed store once (and the last
    synthesis once more), off the rule the OLA kernel. The result within
    1e-3 * max of the CPU's float32 plain versions after 3 iterations."""
    gen = torch.Generator(device=dev).manual_seed(wl)
    x = torch.randn(44100, device=dev, generator=gen)
    win = hamming(wl)
    mag = zaftpu_torch.stft(x, win, step)[:wl // 2 + 1].abs()
    half, window = rfft.frames_rfft_fft.launches, \
        irfft.istft_ola_fft_window.launches
    out = zaftpu_torch.griffin_lim(mag, win, step, iterations=3)
    on_rule = rfft.fits(wl)
    assert rfft.frames_rfft_fft.launches - half == (
        3 if rfft.half_applies(wl) else 0)
    assert irfft.istft_ola_fft_window.launches - window == (4 if on_rule
                                                            else 0)
    ref = zaftpu_torch.griffin_lim(mag.cpu(), win, step, iterations=3)
    assert out.is_cuda and out.shape == ref.shape
    assert _rel_err(out.cpu().double(), ref.double()) < 1e-3


# The dials' pass counts on the twins (ZAFTPU_PRECISION=high: 3 bf16
# passes, default: 1) and the bf16 compute dtype.

PASS_COUNTS = [3, 1]


@pytest.mark.parametrize("passes", PASS_COUNTS)
@pytest.mark.parametrize("wl,step,t", S4_SHAPES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
@pytest.mark.parametrize("offset", [0, 1])
def test_analysis_twins_at_pass_count_match_plain(dev, passes, wl, step, t,
                                                  lead, offset):
    """B1's, B3's, B12's and B2's twins at 3 and 1 passes against their
    plain versions at the same count (the same bf16 products, float32 sums
    in another order), B3's and B12's bit-equal to B1's twin."""
    padded, win = _inputs(wl, step, t, dev, lead, offset)
    args = (padded, win, wl, step, t)
    half = fused.frames_rfft_split4(*args, passes=passes)
    ref = fused.frames_rfft_split4_plain(*args, passes=passes)
    assert half.shape == ref.shape and _rel_err(half, ref) < 1e-4
    assert not torch.equal(half, fused.frames_rfft_split4(*args))
    full = fused.frames_rfft_full_split4(*args, passes=passes)
    assert torch.equal(full, tfft.conjugate_mirror(half, wl))
    re, im = fused.frames_matmul2_split4(*args, passes=passes)
    assert torch.equal(torch.complex(re, im), half)
    if wl % 2 == 0:
        ops = policy.presplit(torch.from_numpy(
            tmdct._direct_forward_ops_padded(wl)).to(dev))
        got = fused.frames_op_split4(padded, win, ops, wl // 2, wl, step, t,
                                     passes=passes)
        ref = fused.frames_op_split4_plain(padded, win, ops, wl // 2, wl,
                                           step, t, passes=passes)
        assert got.shape == ref.shape and _rel_err(got, ref) < 1e-4


@pytest.mark.parametrize("passes", PASS_COUNTS)
@pytest.mark.parametrize("wl,step,t", S4_SHAPES)
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_synthesis_twins_at_pass_count_match_plain(dev, passes, wl, step, t,
                                                   lead):
    rng = np.random.default_rng(wl + t)
    f = wl // 2 + 1
    h = torch.from_numpy(rng.standard_normal((2, *lead, t, f)).astype(
        np.float32)).to(dev)
    got = synth.istft_ola_split4(h[0], h[1], wl, step, 0.5, passes=passes)
    ref = synth.istft_ola_split4_plain(h[0], h[1], wl, step, 0.5,
                                       passes=passes)
    assert got.shape == ref.shape and _rel_err(got, ref) < 1e-4
    if wl % 2 == 0:
        c = torch.from_numpy(rng.standard_normal((*lead, t, wl // 2)).astype(
            np.float32)).to(dev)
        wb = vorbis(wl).tobytes()
        got = synth.imdct_ola_split4(c, wl // 2, wb, passes=passes)
        ref = synth.imdct_ola_split4_plain(c, wl // 2, wb, passes=passes)
        assert got.shape == ref.shape and _rel_err(got, ref) < 1e-4


@pytest.mark.parametrize("passes", PASS_COUNTS)
@pytest.mark.parametrize("wl,step,t", S4_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_mel_rows_twin_at_pass_count_matches_plain(dev, passes, wl, step, t,
                                                   offset):
    padded, win = _inputs(wl, step, t, dev, (2,), offset)
    fbt = torch.rand(wl // 2, 20,
                     generator=torch.Generator().manual_seed(wl)).to(dev)
    for power in (False, True):
        got = melfused.mel_rows_split4(padded, win, fbt, wl, step, t, power,
                                       passes=passes)
        ref = melfused.mel_rows_split4_plain(padded, win, fbt, wl, step, t,
                                             power, passes=passes)
        assert got.shape == ref.shape and _rel_err(got, ref) < 1e-4


@pytest.mark.parametrize("passes", PASS_COUNTS)
@pytest.mark.parametrize("sr,bins,fmin,fmax,t", CQT_GEOMETRIES)
@pytest.mark.parametrize("lead,offset", [((), 0), ((2,), 0), ((), 1)])
def test_cqt_twin_at_pass_count_matches_plain(dev, cqt_cache, passes, sr,
                                              bins, fmin, fmax, t, lead,
                                              offset):
    kern = zaftpu_torch.cqtkernel(sr, bins, fmin, fmax)
    step, length, f = round(sr / 25), kern.fft_length, kern.number_frequencies
    ops = torch.from_numpy(cqtslab.time_ops_split4(kern.time_kernel)).to(
        device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(sr + t + 2)
    n = (t - 1) * step + length
    sig = torch.from_numpy(rng.standard_normal(
        (*lead, n + offset)).astype(np.float32)).to(dev)[..., offset:]
    got = cqtslab.cqt_magnitudes_split4(sig, ops, step, length, t, f,
                                        passes=passes)
    ref = cqtslab.cqt_magnitudes_split4_plain(sig, ops, step, length, t, f,
                                              passes=passes)
    assert got.shape == ref.shape == (*lead, t, f)
    assert _rel_err(got, ref) < 1e-4


def test_twin_entries_refuse_other_pass_counts(dev):
    padded, win = _inputs(512, 256, 9, dev)
    for passes in (0, 2):
        with pytest.raises(ValueError, match="1, 3 or 4"):
            fused.frames_rfft_split4(padded, win, 512, 256, 9,
                                     passes=passes)


def test_bf16_cqt_runs_the_twin_at_one_pass(dev, cqt_cache, monkeypatch):
    """Under compute_dtype("bfloat16") the CQT off the spectral kernel's
    rule (here ZAFTPU_FFT=matmul) launches B10's twin at one pass: within
    1e-4 of max of its plain version, 45 dB or more from the exact CQT;
    mel and MFCC are exempt, bit-equal."""
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    kern = zaftpu_torch.cqtkernel(22050, 12, 110.0, 3520.0)
    x = torch.from_numpy(np.random.default_rng(31).standard_normal(
        22050 * 3).astype(np.float32)).to(dev)
    exact = zaftpu_torch.cqtspectrogram(x, 22050, 25, kern)
    before = cqtslab.cqt_magnitudes_split4.launches
    with zaftpu_torch.compute_dtype("bfloat16"):
        got = zaftpu_torch.cqtspectrogram(x, 22050, 25, kern)
    assert cqtslab.cqt_magnitudes_split4.launches == before + 1
    err = float(((got - exact) ** 2).sum() / (exact ** 2).sum())
    assert 10 * np.log10(1 / err) >= 45.0
    step = round(22050 / 25)
    length = kern.fft_length
    padded = torch.nn.functional.pad(
        x, (-(-(length - step) // 2), (length - step) // 2))
    padded = torch.nn.functional.pad(padded, (0, max(0, cqtslab.slab_needed(
        got.shape[-1], step, length) - padded.shape[-1])))
    ops = tcqt._device_time_kernel(kern, dev, True)
    ref = cqtslab.cqt_magnitudes_split4_plain(
        padded, ops, step, length, got.shape[-1], kern.number_frequencies,
        passes=1)
    assert _rel_err(got.transpose(-1, -2), ref) < 1e-4
    fb = zaftpu_torch.melfilterbank(22050, 1024, 40)
    win = hamming(1024)
    mel = zaftpu_torch.melspectrogram(x, win, 512, fb)
    mf = zaftpu_torch.mfcc(x, win, 512, fb, 13)
    with zaftpu_torch.compute_dtype("bfloat16"):
        assert torch.equal(zaftpu_torch.melspectrogram(x, win, 512, fb), mel)
        assert torch.equal(zaftpu_torch.mfcc(x, win, 512, fb, 13), mf)


@pytest.mark.parametrize("geometry", [(22050, 12, 110.0, 3520.0),
                                      (8000, 12, 3.0, 12.0),
                                      (8000, 12, 1.5, 6.0)])
def test_bf16_cqt_takes_the_spectral_kernel(dev, cqt_cache, monkeypatch,
                                            geometry):
    """Under compute_dtype("bfloat16") a CQT on the spectral kernel's rule
    (L 4,096, and L 65,536 and 131,072 on the clusters) launches that
    kernel once and equals the float32 CQT bit for bit: bfloat16 lowers
    only the time-domain route."""
    for name in ("ZAFTPU_PRECISION", "ZAFTPU_CQT_SCHEME", "ZAFTPU_FFT"):
        monkeypatch.delenv(name, raising=False)
    sr = geometry[0]
    kern = zaftpu_torch.cqtkernel(*geometry)
    x = torch.from_numpy(np.random.default_rng(32).standard_normal(
        sr * 3).astype(np.float32)).to(dev)
    f32 = zaftpu_torch.cqtspectrogram(x, sr, 25, kern)
    counter = _cqt_fft_counter(kern.fft_length)
    before = (counter.launches, cqtslab.cqt_magnitudes_split4.launches)
    with zaftpu_torch.compute_dtype("bfloat16"):
        got = zaftpu_torch.cqtspectrogram(x, sr, 25, kern)
    assert (counter.launches, cqtslab.cqt_magnitudes_split4.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(got, f32)


def _short_wav(tmp_path, seconds=3, sr=22050):
    from zaftpu_torch.io import native

    x = np.random.default_rng(41).uniform(-0.5, 0.5, sr * seconds)
    path = tmp_path / "short.wav"
    native.write_i16(path, sr, (x * 32767).astype(np.int16))
    return str(path)


@pytest.mark.parametrize("kind", ["spectrogram", "melspectrogram", "mdct",
                                  "cqtspectrogram"])
def test_streaming_pipeline_bit_equal_across_prefetch(dev, tmp_path,
                                                      cqt_cache, kind):
    """The streamed features equal the whole-signal transform of the same
    samples on the card, and the result does not depend on how many blocks
    are in flight (a pinned buffer reused too early would show here)."""
    from zaftpu_torch.io import pipeline
    from zaftpu_torch.io.stream import BlockReader

    path = _short_wav(tmp_path)
    reader = BlockReader(path, 1)
    assert reader.native
    x = torch.from_numpy(reader.read_span(0, reader.frames)).to(dev)
    win = hamming(1024)
    fb = zaftpu_torch.melfilterbank(22050, 1024, 40)
    kern = zaftpu_torch.cqtkernel(22050, 12, 110.0, 3520.0)
    runs = {
        "spectrogram": (lambda **k: pipeline.streaming_spectrogram(
            path, win, 512, block_frames=13, **k),
            lambda: zaftpu_torch.spectrogram(x, win, 512)),
        "melspectrogram": (lambda **k: pipeline.streaming_melspectrogram(
            path, win, 512, fb, block_frames=13, **k),
            lambda: zaftpu_torch.melspectrogram(x, win, 512, fb)),
        "mdct": (lambda **k: pipeline.streaming_mdct(
            path, vorbis(1024), block_frames=13, **k),
            lambda: zaftpu_torch.mdct(x, vorbis(1024))),
        "cqtspectrogram": (lambda **k: pipeline.streaming_cqtspectrogram(
            path, 22050, 25, kern, block_frames=7, **k),
            lambda: zaftpu_torch.cqtspectrogram(x, 22050, 25, kern)),
    }
    stream, whole = runs[kind]
    stats = pipeline.StreamStats()
    outs = [stream(prefetch=p) for p in (1, 2)]
    outs.append(stream(prefetch=3, stats=stats))
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    ref = whole().cpu().numpy()
    assert outs[0].shape == ref.shape
    np.testing.assert_array_equal(outs[0], ref)
    assert stats.blocks >= 3 and stats.compute_s > 0 and stats.upload_s > 0


def test_streaming_synthesis_on_card_matches_whole(dev, tmp_path):
    from zaftpu_torch.io import pipeline
    from zaftpu_torch.io.wav import wavread

    x = torch.from_numpy(np.random.default_rng(43).uniform(
        -0.5, 0.5, 30000).astype(np.float32)).to(dev)
    win = hamming(1024)
    spec = zaftpu_torch.stft(x, win, 512)
    whole = zaftpu_torch.istft(spec, win, 512).cpu().numpy()
    src = spec.cpu().numpy()
    n = pipeline.streaming_istft(src, win, 512, tmp_path / "a.wav", 22050,
                                 block_frames=11)
    rec, _ = wavread(tmp_path / "a.wav")
    assert n == whole.shape[0]
    np.testing.assert_allclose(rec, whole, atol=1e-6)
    coeffs = zaftpu_torch.mdct(x, vorbis(1024))
    whole = zaftpu_torch.imdct(coeffs, vorbis(1024)).cpu().numpy()
    n = pipeline.streaming_imdct(coeffs.cpu().numpy(), vorbis(1024),
                                 tmp_path / "b.wav", 22050, block_frames=9)
    rec, _ = wavread(tmp_path / "b.wav")
    assert n == whole.shape[0]
    np.testing.assert_allclose(rec, whole, atol=1e-6)


# ---- asnumpy, timed and the bench suite on the card ------------------------

@pytest.mark.parametrize("dtype", [torch.complex64, torch.float32,
                                   torch.float64, torch.bfloat16])
def test_asnumpy_of_cuda_tensors(dev, dtype):
    rng = np.random.default_rng(44)
    host = rng.standard_normal((5, 7)) + (
        1j * rng.standard_normal((5, 7)) if dtype.is_complex else 0)
    x = torch.from_numpy(host).to(dtype).to(dev)
    got = zaftpu_torch.asnumpy(x)
    want = (x.float() if dtype == torch.bfloat16 else x).cpu().numpy()
    assert got.dtype == want.dtype
    assert got.dtype == (np.float32 if dtype == torch.bfloat16
                         else x.cpu().numpy().dtype)
    np.testing.assert_array_equal(got, want)


def test_timed_on_cuda_events(dev):
    from zaftpu_torch.utils.profiling import timed

    x = torch.from_numpy(np.random.default_rng(45).standard_normal(
        44100 * 10).astype(np.float32)).to(dev)
    win = hamming(2048)
    out, stats = timed("stft", lambda: zaftpu_torch.stft(x, win, 1024),
                       frames=432, reps=3, log=False, dispatches=2,
                       target_s=0.01)
    assert out.is_cuda and out.shape == (2048, 432)
    assert 0 < stats.seconds < 0.01
    assert stats.frames_per_second > 1e6


def test_bench_suite_on_the_card(dev):
    from zaftpu_torch.bench import harness

    rows = harness.run_transform_suite(seconds=2.0, reps=2, device="cuda")
    by = {r["transform"]: r for r in rows}
    assert len(rows) == 18
    assert by["stft"]["launches"] == {"rfft.frames_rfft_full_fft": 1}
    assert by["istft"]["launches"] == {"irfft.istft_ola_fft_full": 1}
    assert by["melspectrogram"]["launches"] == {"melfft.mel_rows_fft": 1}
    assert by["cqtspectrogram"]["launches"] == {
        "cqtfft.cqt_magnitudes_fft": 1}
    assert by["griffin_lim"]["launches"]["irfft.istft_ola_fft_window"] == 33
    x = torch.from_numpy(harness._signal(2.0)).to(dev)
    assert by["stft"]["frames"] == zaftpu_torch.stft(
        x, hamming(2048), 1024).shape[1]
    for row in rows:
        assert 0 < row["seconds"] <= row["median_seconds"]


# ---- frame-block sharding on a one-rank NCCL world --------------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """``make_mesh(1)`` of a one-rank NCCL world on a file store (taken
    down after the module), and ``make_mesh_2d(1, 1)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import torch.distributed as dist
    from zaftpu_torch import sharding

    assert dist.is_nccl_available(), "this torch has no NCCL"
    store = tmp_path_factory.mktemp("nccl") / "store"
    sharding.initialize_distributed(init_method=f"file://{store}", rank=0,
                                    world_size=1)
    assert dist.get_backend() == "nccl"
    yield sharding.make_mesh(1), sharding.make_mesh_2d(1, 1)
    dist.destroy_process_group()


def _sharded_cases():
    """(name, sharded call, unsharded call, tolerance x max|ref|) at one
    rank: bit-equal where each frame runs the same kernel; the MFCC's
    DCT is a torch.matmul."""
    from zaftpu_torch import sharding as S

    win, tdac = hamming(2048), vorbis(2048)
    fbank = zaftpu_torch.melfilterbank(44100, 2048, 40)
    cfg = zaftpu_torch.CqtConfig()
    kern = cfg.kernel()
    stft, istft = zaftpu_torch.stft, zaftpu_torch.istft
    return [
        ("stft", lambda x, m: S.stft_sharded(x, win, 1024, m),
         lambda x: stft(x, win, 1024), 0.0),
        ("spectrogram", lambda x, m: S.spectrogram_sharded(x, win, 1024, m),
         lambda x: zaftpu_torch.spectrogram(x, win, 1024), 0.0),
        ("istft", lambda x, m: S.istft_sharded(stft(x, win, 1024), win,
                                               1024, m),
         lambda x: istft(stft(x, win, 1024), win, 1024), 0.0),
        ("roundtrip", lambda x, m: S.istft_sharded(
            S.stft_sharded(x, win, 1024, m), win, 1024, m, block=True),
         lambda x: istft(stft(x, win, 1024), win, 1024), 0.0),
        ("melspectrogram",
         lambda x, m: S.melspectrogram_sharded(x, win, 1024, fbank, m),
         lambda x: zaftpu_torch.melspectrogram(x, win, 1024, fbank), 0.0),
        ("mfcc", lambda x, m: S.mfcc_sharded(x, win, 1024, fbank, 20, m),
         lambda x: zaftpu_torch.mfcc(x, win, 1024, fbank, 20), 1e-6),
        ("mdct", lambda x, m: S.mdct_sharded(x, tdac, m),
         lambda x: zaftpu_torch.mdct(x, tdac), 0.0),
        ("imdct", lambda x, m: S.imdct_sharded(
            S.mdct_sharded(x, tdac, m), tdac, m, block=True),
         lambda x: zaftpu_torch.imdct(zaftpu_torch.mdct(x, tdac), tdac), 0.0),
        ("cqtspectrogram",
         lambda x, m: S.cqtspectrogram_sharded(x, 44100, 25, kern, m),
         lambda x: zaftpu_torch.cqtspectrogram(x, config=cfg), 0.0),
        ("cqtchromagram",
         lambda x, m: S.cqtchromagram_sharded(x, 44100, 25, 24, kern, m),
         lambda x: zaftpu_torch.cqtchromagram(x, config=cfg), 0.0),
        ("cqtspectrogram_tp",
         lambda x, m: S.cqtspectrogram_tp(x, 44100, 25, kern, m),
         lambda x: zaftpu_torch.cqtspectrogram(x, config=cfg), 0.0),
    ]


@pytest.mark.parametrize("case", range(11))
@pytest.mark.parametrize("two_d", [False, True])
def test_sharded_at_one_nccl_rank(dev, nccl_mesh, case, two_d):
    """Each sharded function on one NCCL rank against the unsharded
    transform on the same tensor, on a 1-D and a 1 x 1 mesh."""
    name, sharded, whole, tol = _sharded_cases()[case]
    x = torch.from_numpy(np.random.default_rng(46).standard_normal(
        44100 * 10).astype(np.float32)).to(dev)
    mesh = nccl_mesh[1] if two_d else nccl_mesh[0]
    got, ref = sharded(x, mesh), whole(x)
    assert got.is_cuda and got.shape == ref.shape and got.dtype == ref.dtype
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max()), \
        name


def test_sharded_launches_the_same_kernels(dev, nccl_mesh):
    from zaftpu_torch import sharding as S

    x = torch.from_numpy(np.random.default_rng(47).standard_normal(
        44100 * 5).astype(np.float32)).to(dev)
    win = hamming(2048)
    before = (rfft.frames_rfft_full_fft.launches,
              irfft.istft_ola_fft_full.launches,
              rfft.frames_rfft_full_fft_plain.calls)
    spec = S.stft_sharded(x, win, 1024, nccl_mesh[0])
    S.istft_sharded(spec, win, 1024, nccl_mesh[0], block=True)
    after = (rfft.frames_rfft_full_fft.launches,
             irfft.istft_ola_fft_full.launches,
             rfft.frames_rfft_full_fft_plain.calls)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 0]


def test_sharded_refuses_a_cpu_tensor_on_nccl(dev, nccl_mesh):
    from zaftpu_torch import sharding as S

    with pytest.raises(ValueError, match="gloo"):
        S.stft_sharded(torch.zeros(8192), hamming(2048), 1024, nccl_mesh[0])


def test_run_scaling_on_the_card(dev, nccl_mesh):
    from zaftpu_torch.bench import harness

    rows = harness.run_scaling(seconds=5.0, reps=2, device="cuda")
    assert [r["devices"] for r in rows] == [1]
    assert rows[0]["scaling_efficiency"] == 1.0 and rows[0]["seconds"] > 0
