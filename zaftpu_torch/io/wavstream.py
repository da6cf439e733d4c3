"""Incremental WAV writing for streaming synthesis (the port of
``zaftpu.io.wavstream``).

The whole-file writers (:func:`zaftpu_torch.io.native.write_f32`,
``wavwrite``) need the full signal in memory; hour-scale synthesis
(streaming ISTFT/IMDCT, :mod:`zaftpu_torch.io.pipeline`) instead appends
fixed-size blocks as they are produced and patches the RIFF/data sizes once
at the end. IEEE-float32 format (format code 3) matches the write contract
(float samples pass through unscaled; see :mod:`zaftpu_torch.io.wav` on the
deliberate divergence from reference zaf.py:1202 for float-format files),
so a file written here reads back bit-identically through ``wavread`` and
the native codec.

Crash model: data blocks are appended before any size field is updated, so
an interrupted file has a zero-length header but intact samples.
:class:`StreamingWavWriter` opened with ``resume=True`` recovers the frame
count from the file size and :meth:`truncate` drops any samples past the
caller's last checkpoint (the synthesis pipelines store their own
block-level state and truncate to it on restart).
"""

from __future__ import annotations

import os
import struct

import numpy as np

_HEADER_BYTES = 44  # RIFF(12) + fmt(24) + data chunk header(8)


def _header(sample_rate: int, channels: int, data_bytes: int) -> bytes:
    frame_bytes = 4 * channels
    return b"".join([
        b"RIFF", struct.pack("<I", 36 + data_bytes), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 3, channels, sample_rate,
                             sample_rate * frame_bytes, frame_bytes, 32),
        b"data", struct.pack("<I", data_bytes),
    ])


class StreamingWavWriter:
    """Append-only float32 WAV writer with resume support.

    Args:
        path: output file.
        sample_rate: sampling frequency in Hz.
        channels: interleaved channel count (synthesis pipelines use 1).
        resume: reopen an existing (possibly unfinished) file and continue
            appending; the current frame count is derived from the file
            size, so a file whose header was never patched still resumes.
    """

    def __init__(self, path, sample_rate: int, channels: int = 1,
                 resume: bool = False):
        self.path = os.fspath(path)
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self._frame_bytes = 4 * self.channels
        if resume and os.path.exists(self.path):
            self._f = open(self.path, "r+b")
            size = os.path.getsize(self.path)
            self.frames_written = max(0, size - _HEADER_BYTES) \
                // self._frame_bytes
        else:
            self._f = open(self.path, "w+b")
            self._f.write(_header(self.sample_rate, self.channels, 0))
            self.frames_written = 0

    def append(self, samples: np.ndarray) -> None:
        """Append ``(n,)`` or ``(n, channels)`` float32 frames."""
        block = np.ascontiguousarray(samples, dtype=np.float32)
        n = block.shape[0]
        if block.size != n * self.channels:
            raise ValueError(
                f"expected {self.channels} channel(s), got shape "
                f"{block.shape}")
        self._f.seek(_HEADER_BYTES
                     + self.frames_written * self._frame_bytes)
        block.tofile(self._f)
        self.frames_written += n

    def truncate(self, frames: int) -> None:
        """Drop samples past ``frames`` (resume-to-checkpoint)."""
        frames = int(frames)
        if frames > self.frames_written:
            raise ValueError(
                f"cannot truncate to {frames}: only "
                f"{self.frames_written} frames written")
        self._f.truncate(_HEADER_BYTES + frames * self._frame_bytes)
        self.frames_written = frames

    def close(self) -> None:
        """Patch the RIFF/data sizes and close (idempotent)."""
        if self._f.closed:
            return
        self._f.seek(0)
        self._f.write(_header(self.sample_rate, self.channels,
                              self.frames_written * self._frame_bytes))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
