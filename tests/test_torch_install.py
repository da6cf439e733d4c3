"""What an installed zaftpu_torch needs from its package data: every
non-Python source under zaftpu_torch/ (the CUDA kernels and the native WAV
codec) shipped by a ``[tool.setuptools.package-data]`` glob, found in a
wheel built from the tree; a block reader whose codec source is missing
raising instead of decoding with SciPy; and ``StreamStats.decoder``
naming the decoder a streamed run took."""

import fnmatch
import os
import shutil
import subprocess
import sys
import time
import tomllib
import zipfile
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile

from zaftpu_torch.io import native
from zaftpu_torch.io import pipeline as tpipe
from zaftpu_torch.io.stream import BlockReader
from zaftpu_torch.io.wav import wavread_f32

REPO = Path(__file__).resolve().parent.parent
SOURCE_SUFFIXES = (".cpp", ".cu", ".cuh")
WHEEL_SECONDS = 30  # the wheel check's budget on a CPU


def _sources() -> list:
    return sorted(p.relative_to(REPO) for suffix in SOURCE_SUFFIXES
                  for p in (REPO / "zaftpu_torch").rglob(f"*{suffix}"))


def _shipped(path: Path, package_data: dict) -> bool:
    """Whether a package-data glob ships ``path`` (relative to the repo):
    the glob is relative to its package's directory."""
    for package, globs in package_data.items():
        pkg_dir = Path(*package.split("."))
        try:
            rel = path.relative_to(pkg_dir)
        except ValueError:
            continue
        if any(fnmatch.fnmatch(rel.as_posix(), g) for g in globs):
            return True
    return False


def test_every_native_source_is_package_data():
    with open(REPO / "pyproject.toml", "rb") as fh:
        package_data = tomllib.load(fh)["tool"]["setuptools"]["package-data"]
    sources = _sources()
    assert Path("zaftpu_torch/io/native/wavio.cpp") in sources
    assert any(p.suffix == ".cu" for p in sources)
    assert any(p.suffix == ".cuh" for p in sources)
    missing = [str(p) for p in sources if not _shipped(p, package_data)]
    assert missing == []


def test_wheel_ships_the_codec_source(tmp_path):
    """Build a wheel offline from a copy of the tree and find every source
    in it (the copy keeps build/ and egg-info out of the checkout)."""
    src = tmp_path / "src"
    skip = shutil.ignore_patterns("__pycache__", "*.so", "build")
    for name in ("zaftpu", "zaftpu_torch"):
        shutil.copytree(REPO / name, src / name, ignore=skip)
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src)
    env = {**os.environ, "PIP_DISABLE_PIP_VERSION_CHECK": "1",
           "PIP_NO_INPUT": "1"}
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps",
                    "--no-build-isolation", "--no-index", "--no-cache-dir",
                    "-w", str(tmp_path / "dist"), str(src)],
                   check=True, capture_output=True, env=env,
                   timeout=WHEEL_SECONDS)
    assert time.perf_counter() - t0 < WHEEL_SECONDS
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    assert "zaftpu_torch/io/native/wavio.cpp" in names
    assert {p.as_posix() for p in _sources()} <= names


@pytest.fixture()
def i16_file(tmp_path):
    rng = np.random.default_rng(5)
    data = (rng.uniform(-0.8, 0.8, 20000) * 32767).astype(np.int16)
    path = tmp_path / "x.wav"
    scipy.io.wavfile.write(path, 44100, data)
    return str(path)


def test_missing_codec_source_raises(i16_file, tmp_path, monkeypatch):
    """A missing wavio.cpp is an incomplete install: the reader raises and
    names the file; it does not decode with SciPy."""
    missing = tmp_path / "gone" / "wavio.cpp"
    monkeypatch.setattr(native, "SOURCE", missing)
    opened = dict(BlockReader.opened)
    for call in (lambda: BlockReader(i16_file, 4096),
                 lambda: wavread_f32(i16_file), native.load):
        with pytest.raises(FileNotFoundError, match="incomplete") as err:
            call()
        assert str(missing) in str(err.value)
    assert BlockReader.opened == opened


def test_no_library_still_takes_scipy(i16_file, monkeypatch):
    """Without a library (no compiler) the reader decodes with SciPy, as
    zaftpu's does, and says so."""
    monkeypatch.setattr(native, "load", lambda: None)
    reader = BlockReader(i16_file, 4096)
    assert reader.decoder == "scipy" and not reader.native
    ref = scipy.io.wavfile.read(i16_file)[1] / 32768.0
    np.testing.assert_array_equal(reader.read_span(0, 100),
                                  ref[:100].astype(np.float32))


@pytest.mark.parametrize("codec", ["native", "scipy"])
def test_stream_stats_name_the_decoder(i16_file, monkeypatch, codec):
    if codec == "native" and native.load() is None:
        pytest.skip("native codec unavailable (no g++)")
    if codec == "scipy":
        monkeypatch.setattr(native, "load", lambda: None)
    stats = tpipe.StreamStats()
    win = np.hanning(256)
    out = tpipe.streaming_spectrogram(i16_file, win, 128, block_frames=40,
                                      device="cpu", stats=stats)
    assert stats.decoder == codec
    assert out.shape[1] == stats.frames
