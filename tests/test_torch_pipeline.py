"""zaftpu_torch's resumable streaming pipeline on the CPU, against
zaftpu's: every case of tests/test_pipeline.py with the port's streaming
functions (``device="cpu"``), held against zaftpu's streaming functions on
the same WAV and against the port's own whole-signal transforms, at that
file's tolerances; checkpoint and resume of the analysis and the
synthesis; ``read_span``'s zero fill into a caller's buffer; the card
refused when there is none. The pinned-buffer copies and streams run only
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import scipy.io.wavfile
import torch

import zaftpu
import zaftpu_torch
from zaftpu.core.windows import hamming, vorbis
from zaftpu.io import pipeline as zpipe
from zaftpu_torch.io import pipeline as tpipe
from zaftpu_torch.io.stream import BlockReader
from zaftpu_torch.io.wavstream import StreamingWavWriter

WL, STEP = 512, 256
CPU = {"device": "cpu"}


@pytest.fixture()
def wav(tmp_path, golden):
    data = (golden["signal"] * 32767).astype(np.int16)
    path = tmp_path / "sig.wav"
    scipy.io.wavfile.write(path, 44100, data)
    return str(path), data.astype(np.float64) / 32768.0


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path / "cache"))


def _x(signal):
    return torch.from_numpy(signal.astype(np.float32))


def _np(x):
    return x.detach().cpu().numpy()


def test_streaming_spectrogram_matches_whole(wav):
    path, signal = wav
    win = hamming(WL)
    whole = _np(zaftpu_torch.spectrogram(_x(signal), win.astype(np.float32),
                                         STEP))
    streamed = tpipe.streaming_spectrogram(path, win, STEP, block_frames=37,
                                           **CPU)
    ref = zpipe.streaming_spectrogram(path, win, STEP, block_frames=37)
    assert streamed.shape == whole.shape == ref.shape
    np.testing.assert_array_equal(streamed, whole)
    np.testing.assert_allclose(streamed, ref, atol=1e-4)


def test_streaming_melspectrogram_matches_whole(wav):
    path, signal = wav
    win = hamming(WL)
    fbank = zaftpu_torch.melfilterbank(44100, WL, 32)
    whole = _np(zaftpu_torch.melspectrogram(
        _x(signal), win.astype(np.float32), STEP, fbank))
    streamed = tpipe.streaming_melspectrogram(path, win, STEP, fbank,
                                              block_frames=50, **CPU)
    ref = zpipe.streaming_melspectrogram(path, win, STEP, fbank,
                                         block_frames=50)
    assert streamed.shape == whole.shape == ref.shape
    np.testing.assert_array_equal(streamed, whole)
    np.testing.assert_allclose(streamed, ref, atol=1e-3)


def test_checkpoint_resume(wav, tmp_path):
    """A crashed job resumes from its block checkpoints without recompute,
    to the uninterrupted result bit for bit."""
    path, _ = wav
    win = torch.from_numpy(hamming(WL).astype(np.float32))
    ckpt = str(tmp_path / "ckpt")
    calls = []
    pad_front, t = tpipe._frame_plan(path, WL, STEP)
    assert (pad_front, t) == zpipe._frame_plan(path, WL, STEP)

    def block_fn(samples):
        calls.append(1)
        b = (samples.shape[0] - (WL - STEP)) // STEP
        frames = samples.unfold(0, WL, STEP)[:b] * win
        return torch.fft.rfft(frames).abs()[:, 1:]

    def make():
        return tpipe.StreamingTransform(path, WL, STEP, pad_front, t,
                                        block_fn, block_frames=40,
                                        checkpoint_dir=ckpt, **CPU)

    clean = tpipe.StreamingTransform(path, WL, STEP, pad_front, t, block_fn,
                                     block_frames=40, **CPU).run()
    calls.clear()
    st = make()
    total_blocks = st.num_blocks
    assert total_blocks >= 3

    class Boom(Exception):
        pass

    def fail_after_two(i, n):
        if i >= 1:  # blocks 0 and 1 done (progress fires after the save)
            raise Boom

    with pytest.raises(Boom):
        st.run(progress=fail_after_two)
    # Blocks 0 and 1 completed and block 2 queued ahead (two in flight);
    # its result is dropped with the crash, the checkpoints stand.
    done_calls = len(calls)
    assert done_calls == 3
    out = make().run()
    assert len(calls) == done_calls + (total_blocks - 2)
    assert out.shape == (t, WL // 2)
    np.testing.assert_array_equal(out, clean)
    n_after_resume = len(calls)
    np.testing.assert_array_equal(make().run(), clean)
    assert len(calls) == n_after_resume


def test_streaming_stats_fill_the_callers_record(wav, tmp_path):
    """``stats=`` receives each run's own block and frame counts: a
    resumed run counts only the blocks it computed, and two runs' records
    stay apart."""
    path, signal = wav
    win = hamming(WL)
    ckpt = str(tmp_path / "ckpt")
    first, second = tpipe.StreamStats(), tpipe.StreamStats()
    out = tpipe.streaming_spectrogram(path, win, STEP, block_frames=37,
                                      checkpoint_dir=ckpt, stats=first, **CPU)
    t = out.shape[1]
    assert (first.blocks, first.frames) == (-(-t // 37), t)
    assert first.wall_s > 0 and first.read_s > 0
    again = tpipe.streaming_spectrogram(path, win, STEP, block_frames=37,
                                        checkpoint_dir=ckpt, stats=second,
                                        **CPU)
    np.testing.assert_array_equal(again, out)
    assert (second.blocks, second.frames) == (0, 0)
    assert (first.blocks, first.frames) == (-(-t // 37), t)
    synth = tpipe.StreamStats()
    spec = _np(zaftpu_torch.stft(_x(signal), hamming(WL), STEP))
    tpipe.streaming_istft(spec, hamming(WL), STEP, tmp_path / "rec.wav",
                          44100, block_frames=19, stats=synth, **CPU)
    assert (synth.blocks, synth.frames) == (-(-spec.shape[1] // 19),
                                            spec.shape[1])


def test_read_span_zero_fill(wav):
    path, signal = wav
    reader = BlockReader(path, 1000)
    span = reader.read_span(-100, 300)
    assert span.shape == (300,)
    np.testing.assert_array_equal(span[:100], 0)
    np.testing.assert_allclose(span[100:], signal[:200], atol=1e-4)
    tail = reader.read_span(reader.frames - 50, 200)
    np.testing.assert_array_equal(tail[50:], 0)
    np.testing.assert_allclose(tail[:50], signal[-50:], atol=1e-4)


def test_read_span_zero_fill_with_out(wav):
    """Into a dirty buffer: the zeros are written, not assumed."""
    path, signal = wav
    reader = BlockReader(path, 1000)
    buf = np.full(300, 7.0, np.float32)
    span = reader.read_span(-100, 300, out=buf)
    assert span is buf
    np.testing.assert_array_equal(span[:100], 0)
    np.testing.assert_allclose(span[100:], signal[:200], atol=1e-4)
    buf = np.full(200, -3.0, np.float32)
    tail = reader.read_span(reader.frames - 50, 200, out=buf)
    np.testing.assert_array_equal(tail[50:], 0)
    np.testing.assert_allclose(tail[:50], signal[-50:], atol=1e-4)
    buf = np.full(20, 5.0, np.float32)
    np.testing.assert_array_equal(reader.read_span(-40, 20, out=buf), 0)


def test_streaming_mfcc_matches_whole(wav):
    path, signal = wav
    win = hamming(WL)
    fbank = zaftpu_torch.melfilterbank(44100, WL, 32)
    whole = _np(zaftpu_torch.mfcc(_x(signal), win.astype(np.float32), STEP,
                                  fbank, 13))
    streamed = tpipe.streaming_mfcc(path, win, STEP, fbank, 13,
                                    block_frames=41, **CPU)
    ref = zpipe.streaming_mfcc(path, win, STEP, fbank, 13, block_frames=41)
    assert streamed.shape == whole.shape == ref.shape
    np.testing.assert_array_equal(streamed, whole)
    np.testing.assert_allclose(streamed, ref, atol=1e-3)


@pytest.mark.parametrize("fft", ["auto", "matmul"])
def test_streaming_cqt_matches_whole(wav, cache_dir, fft, monkeypatch):
    """On the spectral kernel's plain version (L 4096, a power of two) and,
    under ZAFTPU_FFT=matmul, on the slab loop."""
    monkeypatch.setenv("ZAFTPU_FFT", fft)
    path, signal = wav
    kern = zaftpu_torch.cqtkernel(44100, 12, 110.0, 3520.0)
    whole = _np(zaftpu_torch.cqtspectrogram(_x(signal), 44100, 25, kern))
    streamed = tpipe.streaming_cqtspectrogram(path, 44100, 25, kern,
                                              block_frames=7, **CPU)
    ref = zpipe.streaming_cqtspectrogram(
        path, 44100, 25, zaftpu.cqtkernel(44100, 12, 110.0, 3520.0),
        block_frames=7)
    assert streamed.shape == whole.shape == ref.shape
    np.testing.assert_allclose(streamed, whole, atol=1e-4)
    np.testing.assert_allclose(streamed, ref, atol=1e-4)


@pytest.mark.parametrize("wl", [WL, 1100])
def test_streaming_mdct_matches_whole(wav, wl):
    """At a window of the fast MDCT's rule and one it refuses (B2)."""
    path, signal = wav
    win = vorbis(wl)
    whole = _np(zaftpu_torch.mdct(_x(signal), win.astype(np.float32)))
    streamed = tpipe.streaming_mdct(path, win, block_frames=23, **CPU)
    ref = zpipe.streaming_mdct(path, win, block_frames=23)
    assert streamed.shape == whole.shape == ref.shape
    np.testing.assert_array_equal(streamed, whole)
    np.testing.assert_allclose(streamed, ref, atol=1e-4)


@pytest.mark.parametrize("memmap", [True, False])
def test_streaming_istft_roundtrip(wav, tmp_path, memmap):
    """streaming_istft of a memory-mapped spectrum equals the whole-signal
    istft through the written WAV file, and zaftpu's streamed file."""
    _, signal = wav
    win = hamming(WL).astype(np.float32)
    x = signal.astype(np.float32)
    spec = _np(zaftpu_torch.stft(torch.from_numpy(x), win, STEP))
    whole = _np(zaftpu_torch.istft(torch.from_numpy(spec), win, STEP))
    np.save(tmp_path / "spec.npy", spec)
    src = np.load(tmp_path / "spec.npy", mmap_mode="r") if memmap else spec
    n = tpipe.streaming_istft(src, win, STEP, tmp_path / "rec.wav", 44100,
                              block_frames=37, **CPU)
    zpipe.streaming_istft(src, win, STEP, tmp_path / "ref.wav", 44100,
                          block_frames=37)
    assert n == whole.shape[0]
    rec, sr = zaftpu_torch.wavread(tmp_path / "rec.wav")
    ref, _ = zaftpu.wavread(tmp_path / "ref.wav")
    assert sr == 44100
    np.testing.assert_allclose(rec, whole.astype(np.float64), atol=1e-6)
    np.testing.assert_allclose(rec, ref, atol=1e-6)
    n = min(len(rec), len(x))
    err = rec[:n] - x[:n]
    assert 10 * np.log10((x[:n] ** 2).sum() / (err ** 2).sum()) > 120.0


@pytest.mark.parametrize("wl", [WL, 1100])
def test_streaming_imdct_roundtrip(wav, tmp_path, wl):
    _, signal = wav
    win = vorbis(wl).astype(np.float32)
    x = signal.astype(np.float32)
    coeffs = _np(zaftpu_torch.mdct(torch.from_numpy(x), win))
    whole = _np(zaftpu_torch.imdct(torch.from_numpy(coeffs), win))
    n = tpipe.streaming_imdct(coeffs, win, tmp_path / "rec.wav", 44100,
                              block_frames=29, **CPU)
    zpipe.streaming_imdct(coeffs, win, tmp_path / "ref.wav", 44100,
                          block_frames=29)
    assert n == whole.shape[0]
    rec, _ = zaftpu_torch.wavread(tmp_path / "rec.wav")
    ref, _ = zaftpu.wavread(tmp_path / "ref.wav")
    np.testing.assert_allclose(rec, whole.astype(np.float64), atol=1e-6)
    np.testing.assert_allclose(rec, ref, atol=1e-6)
    n = min(len(rec), len(x))
    err = rec[:n] - x[:n]
    assert 10 * np.log10((x[:n] ** 2).sum() / (err ** 2).sum()) > 120.0


def test_streaming_synthesis_resume(tmp_path):
    """A crashed synthesis job resumes from its carry and position
    checkpoint: the remaining blocks only, the file identical to an
    uninterrupted run's."""
    t, step, overlap, bf = 10, 4, 3, 3
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((t, step + overlap)).astype(np.float32)
    calls = []

    def fetch(a, b):
        return np.arange(a, b)

    def block_fn(idx):
        calls.append(len(idx))
        out = np.zeros(len(idx) * step + overlap, np.float32)
        for j, fi in enumerate(idx.tolist()):
            out[j * step: j * step + step + overlap] += frames[fi]
        return torch.from_numpy(out)

    trim, target = overlap, t * step - overlap

    def run(out, ckpt, progress=None):
        resume = ckpt is not None and (ckpt / "synthesis_state.npz").exists()
        with StreamingWavWriter(out, 8000, resume=resume) as w:
            s = tpipe.StreamingSynthesis(
                t, fetch, block_fn, step, overlap, trim, target, w,
                block_frames=bf,
                checkpoint_dir=str(ckpt) if ckpt else None, **CPU)
            return s.run(progress=progress)

    ref = tmp_path / "ref.wav"
    run(ref, None)
    clean_calls = list(calls)
    calls.clear()

    class Boom(Exception):
        pass

    def fail_after_two(i, n):
        if i >= 1:
            raise Boom

    out = tmp_path / "out.wav"
    ckpt = tmp_path / "ck"
    ckpt.mkdir()
    with pytest.raises(Boom):
        run(out, ckpt, progress=fail_after_two)
    # Blocks 0 and 1 emitted, block 2 queued ahead and dropped.
    assert len(calls) == 3
    n = run(out, ckpt)
    assert len(calls) == 3 + (len(clean_calls) - 2)
    assert n == target
    a, _ = zaftpu_torch.wavread(ref)
    b, _ = zaftpu_torch.wavread(out)
    np.testing.assert_array_equal(a, b)


def test_streaming_istft_resume(wav, tmp_path):
    """The same crash and resume through streaming_istft itself."""
    _, signal = wav
    win = hamming(WL).astype(np.float32)
    spec = _np(zaftpu_torch.stft(_x(signal), win, STEP))
    tpipe.streaming_istft(spec, win, STEP, tmp_path / "ref.wav", 44100,
                          block_frames=20, **CPU)

    class Boom(Exception):
        pass

    def fail(i, n):
        if i == 2:
            raise Boom

    ckpt = str(tmp_path / "ck")
    with pytest.raises(Boom):
        tpipe.streaming_istft(spec, win, STEP, tmp_path / "out.wav", 44100,
                              block_frames=20, checkpoint_dir=ckpt,
                              progress=fail, **CPU)
    n = tpipe.streaming_istft(spec, win, STEP, tmp_path / "out.wav", 44100,
                              block_frames=20, checkpoint_dir=ckpt, **CPU)
    assert n == spec.shape[1] * STEP - WL + STEP
    a, _ = zaftpu_torch.wavread(tmp_path / "ref.wav")
    b, _ = zaftpu_torch.wavread(tmp_path / "out.wav")
    np.testing.assert_array_equal(a, b)


def test_streaming_wav_writer_resume(tmp_path):
    path = tmp_path / "w.wav"
    x = np.linspace(-1, 1, 100, dtype=np.float32)
    w = StreamingWavWriter(path, 44100)
    w.append(x[:60])
    del w  # a crash: no close(), the header's sizes still zero
    w = StreamingWavWriter(path, 44100, resume=True)
    assert w.frames_written == 60
    w.truncate(40)
    w.append(x[40:])
    w.close()
    back, sr = zaftpu_torch.wavread(path)
    assert sr == 44100
    np.testing.assert_array_equal(np.asarray(back, dtype=np.float32), x)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_device_without_a_card_raises(wav):
    path, _ = wav
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tpipe.StreamingTransform(path, WL, STEP, 0, 10, lambda s: s)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tpipe.streaming_spectrogram(path, hamming(WL), STEP)
