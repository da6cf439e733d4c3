"""zaftpu_torch's I/O layer against zaftpu's: ``wavread`` / ``wavwrite``
(tests/test_io_viz.py's WAV cases), the native codec and the block reader
(tests/test_native_io.py's cases), the codec's source kept identical to
zaftpu's, and ``read_span`` into a caller's buffer."""

import ctypes
import filecmp
import struct
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile

import zaftpu
import zaftpu_torch
from zaftpu.io import native as znative
from zaftpu.io.stream import BlockReader as ZBlockReader
from zaftpu.io.wav import wavread_f32 as zwavread_f32
from zaftpu_torch.io import native
from zaftpu_torch.io.stream import BlockReader
from zaftpu_torch.io.wav import wavread_f32

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def native_lib():
    if native.load() is None:
        pytest.skip("native codec unavailable (no g++)")
    return native


@pytest.fixture()
def i16_file(tmp_path):
    rng = np.random.default_rng(3)
    data = (rng.uniform(-0.8, 0.8, (44100, 2)) * 32767).astype(np.int16)
    path = tmp_path / "x.wav"
    scipy.io.wavfile.write(path, 44100, data)
    return str(path), data


def test_wavio_source_is_zaftpus():
    assert filecmp.cmp(REPO / "zaftpu_torch/io/native/wavio.cpp",
                       REPO / "zaftpu/io/native/wavio.cpp", shallow=False)


def test_codec_builds_in_the_ports_build_directory(native_lib):
    from zaftpu_torch.kernels import _build

    path = native_lib.lib_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert native_lib.load() is native_lib.load()


# ---- wavread / wavwrite (tests/test_io_viz.py) ----------------------------

def test_wav_int16_normalization(tmp_path):
    path = tmp_path / "i16.wav"
    data = np.array([-32768, -16384, 0, 16384, 32767], dtype=np.int16)
    scipy.io.wavfile.write(path, 44100, data)
    signal, sr = zaftpu_torch.wavread(path)
    ref, rsr = zaftpu.wavread(path)
    assert sr == rsr == 44100
    assert signal.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(signal, ref)
    np.testing.assert_array_equal(signal, data / 32768.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wav_float_passthrough_roundtrip(tmp_path, dtype):
    path = tmp_path / "f.wav"
    data = np.random.default_rng(0).uniform(-1, 1, (1000, 2)).astype(dtype)
    zaftpu_torch.wavwrite(data, 22050, path)
    signal, sr = zaftpu_torch.wavread(path)
    ref, _ = zaftpu.wavread(path)
    assert sr == 22050
    np.testing.assert_array_equal(signal, ref)
    np.testing.assert_array_equal(signal, data.astype(np.float64))


def test_wavwrite_matches_zaftpus_file(tmp_path):
    import torch

    data = np.random.default_rng(1).uniform(-1, 1, 500).astype(np.float32)
    zaftpu_torch.wavwrite(torch.from_numpy(data), 8000, tmp_path / "a.wav")
    zaftpu.wavwrite(data, 8000, tmp_path / "b.wav")
    assert (tmp_path / "a.wav").read_bytes() == (
        tmp_path / "b.wav").read_bytes()


# ---- The native codec (tests/test_native_io.py) ---------------------------

def test_info_and_full_read_matches_scipy(native_lib, i16_file):
    path, data = i16_file
    handle = native_lib.WavFile(path)
    ref = znative.WavFile(path)
    assert (handle.sample_rate, handle.channels, handle.bits,
            handle.frames) == (44100, 2, 16, 44100) == (
                ref.sample_rate, ref.channels, ref.bits, ref.frames)
    out = handle.read()
    np.testing.assert_array_equal(out, ref.read())
    np.testing.assert_allclose(out, data.astype(np.float32) / 32768.0,
                               atol=1e-7)


def test_seek_read(native_lib, i16_file):
    path, data = i16_file
    out = native_lib.WavFile(path).read(1000, 256)
    np.testing.assert_array_equal(out, znative.WavFile(path).read(1000, 256))
    np.testing.assert_allclose(out, data[1000:1256] / 32768.0, atol=1e-7)


def test_read_into_a_buffer(native_lib, i16_file):
    """``out=`` decodes straight into the caller's float32 buffer."""
    path, _ = i16_file
    buf = np.full(600, np.nan, np.float32)
    got = native_lib.WavFile(path).read(44000, 300, out=buf)
    assert got.shape == (100, 2)
    assert np.shares_memory(got, buf)
    np.testing.assert_array_equal(got, znative.WavFile(path).read(44000,
                                                                  300))
    with pytest.raises(ValueError):
        native_lib.WavFile(path).read(0, 400, out=buf)


def test_read_past_end_clips(native_lib, i16_file):
    path, _ = i16_file
    assert native_lib.WavFile(path).read(44000, 500).shape == (100, 2)


def test_float32_roundtrip(native_lib, tmp_path):
    rng = np.random.default_rng(4)
    data = rng.uniform(-1, 1, (5000, 2)).astype(np.float32)
    path = str(tmp_path / "f.wav")
    native_lib.write_f32(path, 22050, data)
    handle = native_lib.WavFile(path)
    assert handle.format == 3 and handle.bits == 32
    np.testing.assert_array_equal(handle.read(), data)
    sr, back = scipy.io.wavfile.read(path)
    assert sr == 22050
    np.testing.assert_array_equal(back, data)
    znative.write_f32(str(tmp_path / "z.wav"), 22050, data)
    assert Path(path).read_bytes() == (tmp_path / "z.wav").read_bytes()


def test_i16_write_interop(native_lib, tmp_path):
    data = (np.linspace(-1, 1, 1000) * 32000).astype(np.int16)
    path = str(tmp_path / "i.wav")
    native_lib.write_i16(path, 8000, data)
    sr, back = scipy.io.wavfile.read(path)
    assert sr == 8000
    np.testing.assert_array_equal(back, data)


def test_24bit_decode(native_lib, tmp_path):
    rng = np.random.default_rng(5)
    vals = rng.integers(-2 ** 23, 2 ** 23 - 1, 2048, dtype=np.int32)
    raw = np.zeros((2048, 3), dtype=np.uint8)
    raw[:, 0] = vals & 0xFF
    raw[:, 1] = (vals >> 8) & 0xFF
    raw[:, 2] = (vals >> 16) & 0xFF
    path = str(tmp_path / "b24.wav")
    data_bytes = raw.tobytes()
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + len(data_bytes)) + b"WAVE")
        fh.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 44100,
                                       44100 * 3, 3, 24))
        fh.write(b"data" + struct.pack("<I", len(data_bytes)) + data_bytes)
    out = native_lib.WavFile(path).read()[:, 0]
    np.testing.assert_allclose(out, vals / 8388608.0, atol=1e-7)
    np.testing.assert_array_equal(out, znative.WavFile(path).read()[:, 0])


def test_wavread_f32_matches_zaftpus(i16_file):
    path, _ = i16_file
    f32, sr = wavread_f32(path)
    ref, rsr = zwavread_f32(path)
    assert sr == rsr
    np.testing.assert_array_equal(f32, ref)
    f64, _ = zaftpu_torch.wavread(path)
    np.testing.assert_allclose(f32, f64, atol=1e-7)


def test_malformed_zero_channel_header(native_lib, tmp_path):
    path = tmp_path / "bad.wav"
    fmt = struct.pack("<HHIIHH", 1, 0, 44100, 0, 0, 0)
    data = b"\x00" * 64
    body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE"
                     + body)
    out = np.empty(64, np.float32)
    rc = native_lib.load().zaftpu_wav_read_block(
        str(path).encode(), 0, 16,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    assert rc < 0
    with pytest.raises(ValueError):
        native_lib.WavFile(str(path))


# ---- The block reader ----------------------------------------------------

@pytest.mark.parametrize("mono", [True, False])
def test_block_reader_matches_zaftpus(i16_file, mono):
    path, _ = i16_file
    mine = BlockReader(path, 4096, overlap=128, mono=mono)
    ref = ZBlockReader(path, 4096, overlap=128, mono=mono)
    assert mine.native
    assert (mine.num_blocks, mine.frames, mine.channels,
            mine.sample_rate) == (ref.num_blocks, ref.frames, ref.channels,
                                  ref.sample_rate)
    for (s0, a), (s1, b) in zip(mine, ref):
        assert s0 == s1
        np.testing.assert_array_equal(a, b)
    for start, count in ((-100, 300), (44000, 500), (50000, 10), (7, 4000)):
        np.testing.assert_array_equal(mine.read_span(start, count),
                                      ref.read_span(start, count))


@pytest.mark.parametrize("mono", [True, False])
def test_read_span_into_a_buffer(i16_file, mono):
    """``out=`` holds zaftpu's span, zero outside the file, whatever it
    held before."""
    path, _ = i16_file
    mine = BlockReader(path, 1000, mono=mono)
    ref = ZBlockReader(path, 1000, mono=mono)
    width = () if mono else (2,)
    for start, count in ((-100, 300), (mine.frames - 50, 200), (9, 2000),
                         (-500, 100), (mine.frames + 1, 10)):
        buf = np.full((count, *width), np.nan, np.float32)
        got = mine.read_span(start, count, out=buf)
        assert got is buf
        np.testing.assert_array_equal(buf, ref.read_span(start, count))
    with pytest.raises(ValueError):
        mine.read_span(0, 10, out=np.empty((11, *width), np.float32))


def test_block_reader_fallback_matches_native(i16_file, monkeypatch):
    path, _ = i16_file
    a = BlockReader(path, 4096, overlap=128)
    opened = dict(BlockReader.opened)

    class _Boom:
        def __init__(self, *_):
            raise RuntimeError("forced fallback")

    monkeypatch.setattr("zaftpu_torch.io.native.WavFile", _Boom)
    b = BlockReader(path, 4096, overlap=128)
    assert not b.native and a.native
    assert BlockReader.opened["scipy"] == opened["scipy"] + 1
    for i in (0, 3, a.num_blocks - 1):
        np.testing.assert_array_equal(a.read_block(i), b.read_block(i))
    for start, count in ((-100, 300), (44000, 500)):
        buf = np.empty(count, np.float32)
        np.testing.assert_array_equal(b.read_span(start, count, out=buf),
                                      a.read_span(start, count))
