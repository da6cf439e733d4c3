"""ctypes loader for the native WAV codec (``wavio.cpp``, a copy of
``zaftpu``'s, kept identical by a test).

At first use ``g++`` builds the codec into the port's build directory
(``build/zaftpu_torch/`` at the repository root, beside the CUDA kernels),
named by a hash of the source, so a source edit rebuilds and an unchanged
tree reuses the library. It is a host library: it decodes into any float32
buffer, pinned host memory included. Without a compiler :func:`load`
returns None and the callers take ``zaftpu``'s SciPy path; without the
source (an install that did not ship it) it raises
:class:`FileNotFoundError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from zaftpu_torch.kernels._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "wavio.cpp"
_lock = threading.Lock()
_state: dict = {"lib": None, "tried": False}


def _check_source() -> None:
    if not SOURCE.is_file():
        raise FileNotFoundError(
            f"{SOURCE}: the native WAV codec's source is missing, so this "
            "zaftpu_torch install is incomplete (its package data must ship "
            "zaftpu_torch/io/native/wavio.cpp)")


def lib_path() -> Path:
    """The library's path, keyed on the content of ``wavio.cpp``."""
    _check_source()
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libwavio-{digest}.so"


def _build(path: Path) -> bool:
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
                            str(SOURCE)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)  # atomic: another process sees all or none
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def load():
    """The loaded native library, or None when it cannot be built; raises
    :class:`FileNotFoundError` when ``wavio.cpp`` is missing."""
    _check_source()
    with _lock:
        if _state["lib"] is not None or _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        path = lib_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.zaftpu_wav_info.argtypes = [ctypes.c_char_p, i32p, i32p, i32p,
                                        i32p, ctypes.POINTER(ctypes.c_int64)]
        lib.zaftpu_wav_info.restype = ctypes.c_int
        lib.zaftpu_wav_read_block.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]
        lib.zaftpu_wav_read_block.restype = ctypes.c_int64
        lib.zaftpu_wav_write_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]
        lib.zaftpu_wav_write_f32.restype = ctypes.c_int
        lib.zaftpu_wav_write_i16.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int16)]
        lib.zaftpu_wav_write_i16.restype = ctypes.c_int
        _state["lib"] = lib
        return lib


class WavFile:
    """Seekable WAV handle backed by the native codec."""

    def __init__(self, path):
        lib = load()
        if lib is None:
            raise RuntimeError("native wav codec unavailable")
        self._lib = lib
        self.path = os.fspath(path)
        sr, ch, bits, fmt = (ctypes.c_int32() for _ in range(4))
        frames = ctypes.c_int64()
        rc = lib.zaftpu_wav_info(self.path.encode(), ctypes.byref(sr),
                                 ctypes.byref(ch), ctypes.byref(bits),
                                 ctypes.byref(fmt), ctypes.byref(frames))
        if rc != 0:
            raise ValueError(f"cannot parse WAV header: {path} (rc={rc})")
        self.sample_rate = sr.value
        self.channels = ch.value
        self.bits = bits.value
        self.format = fmt.value
        self.frames = frames.value

    def read(self, start: int = 0, count: int | None = None,
             out: np.ndarray | None = None) -> np.ndarray:
        """Decode ``count`` frames from ``start`` as float32
        ``(count, channels)``, normalised to the reference contract, into
        ``out`` when given (a C-contiguous float32 array of at least
        ``count * channels`` values, pinned host memory for instance);
        returns the frames read."""
        if count is None:
            count = self.frames - start
        if out is None:
            out = np.empty((count, self.channels), dtype=np.float32)
        elif (out.dtype != np.float32 or not out.flags.c_contiguous
              or out.size < count * self.channels):
            raise ValueError(f"out must be C-contiguous float32 holding "
                             f"{count * self.channels} values")
        got = self._lib.zaftpu_wav_read_block(
            self.path.encode(), start, count,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if got < 0:
            raise IOError(f"wav read failed (rc={got})")
        return out.reshape(-1)[:got * self.channels].reshape(
            got, self.channels)


def _write(fn, ctype, dtype, path, sample_rate, data) -> None:
    lib = load()
    if lib is None:
        raise RuntimeError("native wav codec unavailable")
    data = np.ascontiguousarray(data, dtype=dtype)
    channels = 1 if data.ndim == 1 else data.shape[1]
    rc = getattr(lib, fn)(os.fspath(path).encode(), int(sample_rate),
                          channels, data.shape[0],
                          data.ctypes.data_as(ctypes.POINTER(ctype)))
    if rc != 0:
        raise IOError(f"wav write failed (rc={rc})")


def write_f32(path, sample_rate: int, data: np.ndarray) -> None:
    """Write an IEEE float32 WAV."""
    _write("zaftpu_wav_write_f32", ctypes.c_float, np.float32, path,
           sample_rate, data)


def write_i16(path, sample_rate: int, data: np.ndarray) -> None:
    """Write a 16-bit PCM WAV."""
    _write("zaftpu_wav_write_i16", ctypes.c_int16, np.int16, path,
           sample_rate, data)
