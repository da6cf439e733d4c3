"""Streaming block reader: the data-loading path for long recordings (the
port of ``zaftpu.io.stream``).

An hour of audio need not sit in memory before analysis. A
:class:`BlockReader` yields fixed-size float32 blocks with ``window_length
- step`` samples of overlap carried between them, so per-block STFT / mel /
CQT results concatenate to the whole-signal result; :meth:`read_span`
reads any span of the padded stream, zero outside the file, into a buffer
the caller gives (pinned host memory for the pipeline's uploads). Decoding
runs on the native C++ codec (:mod:`zaftpu_torch.io.native`) when it
builds, seeking by frame without a whole-file load, else (no compiler, or
a file the codec cannot parse) on SciPy's ``mmap`` reader. A missing codec
source is an incomplete install and raises.
"""

from __future__ import annotations

import numpy as np


def _normalised(raw: np.ndarray) -> np.ndarray:
    """SciPy samples as float32 ``(n, channels)``, integers scaled by
    ``2^(8*itemsize - 1)``."""
    if np.issubdtype(raw.dtype, np.integer):
        data = raw.astype(np.float32) / float(
            2 ** (raw.dtype.itemsize * 8 - 1))
    else:
        data = raw.astype(np.float32)
    return data[:, None] if data.ndim == 1 else data


class BlockReader:
    """Iterate a WAV file as overlapping float32 blocks.

    Args:
        path: WAV file path.
        block_samples: samples per yielded block (hop between block starts).
        overlap: extra trailing samples appended to each block (e.g.
            ``window_length - step`` so frame analysis is seamless across
            block boundaries); the final block is zero-padded to full size.
        mono: average the channels (the reference examples' convention).

    Yields ``(start_sample, block)`` with ``block.shape == (block_samples +
    overlap,)``. ``native`` and ``decoder`` say which decoder it took; the
    class counts the readers opened on each (``opened``). Raises
    :class:`FileNotFoundError` when the codec's source is missing.
    """

    opened = {"native": 0, "scipy": 0}

    def __init__(self, path, block_samples: int, overlap: int = 0,
                 mono: bool = True):
        self.path = path
        self.block_samples = int(block_samples)
        self.overlap = int(overlap)
        self.mono = mono
        self._native = None
        self._mmap = None
        from zaftpu_torch.io import native

        try:
            # RuntimeError: no library (no compiler); ValueError: a header
            # the codec cannot parse. A missing source raises through.
            self._native = native.WavFile(path)
            self.sample_rate = self._native.sample_rate
            self.channels = self._native.channels
            self.frames = self._native.frames
        except (RuntimeError, ValueError):
            import scipy.io.wavfile

            sr, data = scipy.io.wavfile.read(path, mmap=True)
            self.sample_rate = sr
            self._mmap = data
            self.channels = 1 if data.ndim == 1 else data.shape[1]
            self.frames = data.shape[0]
        BlockReader.opened[self.decoder] += 1

    @property
    def native(self) -> bool:
        return self._native is not None

    @property
    def decoder(self) -> str:
        """``"native"`` or ``"scipy"``."""
        return "native" if self.native else "scipy"

    @property
    def num_blocks(self) -> int:
        return -(-self.frames // self.block_samples)

    def _decode(self, start: int, count: int) -> np.ndarray:
        """``count`` frames from ``start`` (inside the file) as float32
        ``(count, channels)``."""
        if self._native is not None:
            return self._native.read(start, count)
        return _normalised(self._mmap[start:start + count])

    def read_block(self, index: int) -> np.ndarray:
        """Block ``index`` as ``(block_samples + overlap,)`` float32."""
        start = index * self.block_samples
        want = self.block_samples + self.overlap
        data = self._decode(start, min(want, self.frames - start))
        block = data.mean(axis=1) if self.mono else data
        if block.shape[0] < want:
            pad = [(0, want - block.shape[0])] + [(0, 0)] * (block.ndim - 1)
            block = np.pad(block, pad)
        return np.ascontiguousarray(block, dtype=np.float32)

    def read_span(self, start: int, count: int,
                  out: np.ndarray | None = None) -> np.ndarray:
        """The ``(count,)`` span (``(count, channels)`` when not mono) from
        sample ``start``, zero outside the file: the primitive the
        resumable pipelines read the padded stream with. ``out``, a
        C-contiguous float32 array of that shape, receives it (a mono file
        is decoded straight into it) and is returned."""
        width = () if self.mono else (self.channels,)
        if out is None:
            out = np.zeros((count, *width), dtype=np.float32)
        elif (out.shape != (count, *width) or out.dtype != np.float32
              or not out.flags.c_contiguous):
            raise ValueError(f"out must be C-contiguous float32 "
                             f"{(count, *width)}, got {out.dtype} "
                             f"{out.shape}")
        lo = max(start, 0)
        hi = min(start + count, self.frames)
        if hi <= lo:
            out[...] = 0
            return out
        out[:lo - start] = 0
        out[hi - start:] = 0
        dst = out[lo - start:hi - start]
        if self._native is not None and (self.channels == 1
                                         or not self.mono):
            self._native.read(lo, hi - lo, out=dst)
        elif self.mono:
            np.mean(self._decode(lo, hi - lo), axis=1, out=dst)
        else:
            dst[...] = self._decode(lo, hi - lo)
        return out

    def __iter__(self):
        for i in range(self.num_blocks):
            yield i * self.block_samples, self.read_block(i)
