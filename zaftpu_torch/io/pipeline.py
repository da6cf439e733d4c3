"""Resumable streaming analysis and synthesis of long recordings (the port
of ``zaftpu.io.pipeline``).

Transforms are frame-local, so recovering from a failure means running the
failed block again. A long WAV is analysed block by block through
:meth:`zaftpu_torch.io.stream.BlockReader.read_span`, each block's features
go to disk as soon as they are fetched, and a restarted job skips every
block that has a checkpoint; host and device memory stay bounded whatever
the signal's length. Each block's body is the port's own route for the
whole-signal transform (the same kernels), so a streamed result equals the
whole-signal one. Frame ``j`` covers padded-stream samples ``[j*step,
j*step + window_length)``, the padded stream being ``pad_front`` zeros, the
signal and trailing zeros: the whole-signal geometry, served lazily.
Beyond ``zaftpu``'s arguments the entry points take ``device``
(``"cuda"`` by default), ``progress`` (called as ``progress(block,
blocks)`` after each block is checkpointed), ``stats`` (a fresh
:class:`StreamStats` the run fills with its time split) and, for the
analyses, ``prefetch`` (blocks in flight, 2 as in ``zaftpu``).

The host pipeline (:class:`_Stage`): each block is decoded into one of
``prefetch`` pinned host buffers, uploaded with ``non_blocking=True`` on a
copy stream of its own, the compute stream waits on that upload's event,
and the result comes back with ``non_blocking=True`` into a pinned buffer;
the host waits only on that block's event before it checkpoints it. A
buffer is reused only after its last upload's event has completed. So
while block ``k`` computes, the host decodes block ``k + 1``: ``zaftpu``
gets the same overlap from JAX's asynchronous dispatch. A copy from
pageable memory would instead wait for the queued kernels. On the CPU
(``device="cpu"``) the same loop runs the plain versions with no streams.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time

import numpy as np
import torch

from zaftpu_torch.io.stream import BlockReader
from zaftpu_torch.io.wavstream import StreamingWavWriter


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: the streaming pipeline runs on the card unless "
            "device='cpu' is passed")
    return dev


@dataclasses.dataclass
class StreamStats:
    """Where a run's time went: host seconds decoding into the pinned
    buffers (``read_s``), device seconds of the uploads (``upload_s``, on
    the copy stream), of the blocks' kernels (``compute_s``) and of the
    fetches (``fetch_s``), all from CUDA events on the card, and the run's
    wall seconds. ``decoder`` is the WAV decoder an analysis read with
    (``"native"`` or ``"scipy"``; None for a synthesis, which decodes
    none)."""

    blocks: int = 0
    frames: int = 0
    read_s: float = 0.0
    upload_s: float = 0.0
    compute_s: float = 0.0
    fetch_s: float = 0.0
    wall_s: float = 0.0
    decoder: str | None = None

    @property
    def busy_share(self) -> float:
        """The device's compute seconds over the wall seconds."""
        return self.compute_s / self.wall_s if self.wall_s else 0.0


class _Stage:
    """``slots`` pinned host buffers, device buffers, a copy stream and the
    events that order them (see the module's docstring); on the CPU plain
    arrays and no streams."""

    def __init__(self, device, slots: int, stats: StreamStats | None = None):
        self.device = _device(device)
        self.cuda = self.device.type == "cuda"
        self.slots = max(1, int(slots))
        self._host = [None] * self.slots
        self._dev = [None] * self.slots
        self._out = [None] * self.slots
        self._uploaded = [None] * self.slots  # event: the slot's last upload
        self._done = [None] * self.slots      # event: its block's kernels
        self._turn = 0
        self._spans = {"upload_s": [], "compute_s": [], "fetch_s": []}
        self.stats = StreamStats() if stats is None else stats
        self._t0 = time.perf_counter()
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(self.device)

    def _pair(self, kind: str):
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        self._spans[kind].append(pair)
        return pair

    def host_buffer(self, shape: tuple, dtype) -> tuple[int, np.ndarray]:
        """The next slot and a host array of ``shape`` to fill: its pinned
        buffer, once the slot's last upload has completed."""
        slot = self._turn
        self._turn = (slot + 1) % self.slots
        if not self.cuda:
            return slot, np.empty(shape, dtype)
        if self._uploaded[slot] is not None:
            self._uploaded[slot].synchronize()
        n = int(np.prod(shape))
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        buf = self._host[slot]
        if buf is None or buf.numel() < n or buf.dtype != tdtype:
            buf = torch.empty(n, dtype=tdtype, pin_memory=True)
            self._host[slot] = buf
        return slot, buf[:n].numpy().reshape(shape)

    def upload(self, slot: int, host: np.ndarray) -> torch.Tensor:
        """``host`` (the slot's buffer) on the device; the compute stream
        waits for the copy, the host does not."""
        if not self.cuda:
            return torch.from_numpy(host)
        n = host.size
        src = self._host[slot][:n].view(host.shape)
        compute = torch.cuda.current_stream(self.device)
        dev = self._dev[slot]
        if dev is None or dev.numel() < n or dev.dtype != src.dtype:
            dev = torch.empty(n, dtype=src.dtype, device=self.device)
            self._dev[slot] = dev
            # The new buffer may be memory the compute stream has queued
            # work on: the copy stream goes after that work.
            self.copy_stream.wait_stream(compute)
        dst = dev[:n].view(host.shape)
        start, end = self._pair("upload_s")
        with torch.cuda.stream(self.copy_stream):
            if self._done[slot] is not None:
                # The block that last read this device buffer has finished.
                self.copy_stream.wait_event(self._done[slot])
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
        self._uploaded[slot] = end
        compute.wait_event(end)
        return dst

    def compute(self, slot: int, fn, x: torch.Tensor):
        """``fn(x)`` on the compute stream, between timing events."""
        if not self.cuda:
            return fn(x)
        start, end = self._pair("compute_s")
        start.record()
        y = fn(x)
        end.record()
        self._done[slot] = end
        return y

    def fetch(self, slot: int, y) -> tuple:
        """Start ``y``'s copy into the slot's pinned output buffer; returns
        the handle :meth:`wait` takes."""
        y = torch.as_tensor(y)
        if not self.cuda or not y.is_cuda:
            return y.detach().cpu(), None
        out = self._out[slot]
        if out is None or out.numel() < y.numel() or out.dtype != y.dtype:
            out = torch.empty(y.numel(), dtype=y.dtype, pin_memory=True)
            self._out[slot] = out
        host = out[:y.numel()].view(y.shape)
        start, end = self._pair("fetch_s")
        start.record()
        host.copy_(y, non_blocking=True)
        end.record()
        return host, end

    @staticmethod
    def wait(handle) -> np.ndarray:
        """The fetched block as a numpy view of its host buffer, once its
        copy has completed (valid until its slot is fetched into again)."""
        host, event = handle
        if event is not None:
            event.synchronize()
        return host.numpy()

    def finish(self) -> StreamStats:
        """Wait for the device and fill in :attr:`stats`."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
            for kind, pairs in self._spans.items():
                setattr(self.stats, kind, sum(
                    a.elapsed_time(b) for a, b in pairs) / 1e3)
        self.stats.wall_s = time.perf_counter() - self._t0
        return self.stats


class StreamingTransform:
    """Drive a per-frame-block feature function over a long WAV,
    resumably.

    Args:
        path: WAV file.
        window_length, step: frame geometry.
        pad_front: zeros prepended to the stream (centring pad).
        number_times: total frames to produce.
        block_fn: ``(samples (block_frames*step + window_length - step,),
            a float32 tensor on ``device``) -> features (block_frames, F)``
            on the same device.
        block_frames: frames per block.
        checkpoint_dir: directory for per-block ``.npy`` checkpoints
            (None: no checkpoints).
        device: where the blocks run, ``"cuda"`` by default; without a
            card that raises rather than running on the CPU.

    :attr:`stats` holds the last run's time split.
    """

    def __init__(self, path, window_length: int, step: int, pad_front: int,
                 number_times: int, block_fn, block_frames: int = 4096,
                 checkpoint_dir: str | None = None, device="cuda"):
        self.device = _device(device)
        self.reader = BlockReader(path, block_samples=block_frames * step,
                                  overlap=window_length - step)
        self.window_length = window_length
        self.step = step
        self.pad_front = pad_front
        self.number_times = number_times
        self.block_fn = block_fn
        self.block_frames = block_frames
        self.checkpoint_dir = checkpoint_dir
        self.stats = StreamStats()
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)

    @property
    def num_blocks(self) -> int:
        return -(-self.number_times // self.block_frames)

    def _ckpt_path(self, index: int) -> str:
        return os.path.join(self.checkpoint_dir, f"block{index:08d}.npy")

    def _keep(self, index: int) -> int:
        return min(self.block_frames,
                   self.number_times - index * self.block_frames)

    def dispatch_block(self, index: int, stage: _Stage):
        """Decode block ``index`` into a pinned buffer, upload it, queue its
        kernels and its fetch, and return without waiting for the device."""
        first_frame = index * self.block_frames
        span_start = first_frame * self.step - self.pad_front
        span_len = (self.block_frames * self.step
                    + self.window_length - self.step)
        t0 = time.perf_counter()
        slot, host = stage.host_buffer((span_len,), np.float32)
        self.reader.read_span(span_start, span_len, out=host)
        stage.stats.read_s += time.perf_counter() - t0
        samples = stage.upload(slot, host)
        return stage.fetch(slot, stage.compute(slot, self.block_fn, samples))

    def run(self, progress=None, prefetch: int = 2,
            stats: StreamStats | None = None) -> np.ndarray:
        """All blocks, resuming from checkpoints; returns ``(T, F)``.

        Up to ``prefetch`` blocks are in flight: block ``k``'s fetch and
        checkpoint overlap block ``k+1``'s decode, upload and kernels.
        :attr:`stats` (and ``stats``, if given) holds the run's time
        split."""
        stage = _Stage(self.device, prefetch, stats)
        stage.stats.decoder = self.reader.decoder
        inflight: collections.deque = collections.deque()
        result = None

        def store(index: int, block: np.ndarray) -> None:
            nonlocal result
            if result is None:
                result = np.empty((self.number_times, *block.shape[1:]),
                                  block.dtype)
            first = index * self.block_frames
            result[first:first + block.shape[0]] = block

        def drain(limit: int) -> None:
            while len(inflight) > limit:
                index, handle = inflight.popleft()
                block = stage.wait(handle)[:self._keep(index)]
                if self.checkpoint_dir:
                    path = self._ckpt_path(index)
                    tmp = path + f".tmp{os.getpid()}.npy"
                    np.save(tmp, block)
                    os.replace(tmp, path)
                store(index, block)
                stage.stats.blocks += 1
                stage.stats.frames += block.shape[0]
                if progress:
                    progress(index, self.num_blocks)

        for index in range(self.num_blocks):
            if self.checkpoint_dir:
                path = self._ckpt_path(index)
                if os.path.exists(path):
                    store(index, np.load(path))
                    continue
            inflight.append((index, self.dispatch_block(index, stage)))
            drain(max(0, prefetch - 1))
        drain(0)
        self.stats = stage.finish()
        return result


def _frame_plan(path, window_length: int, step: int):
    from zaftpu_torch.core.frame import stft_padding

    reader = BlockReader(path, block_samples=1)
    pad_front, _, t = stft_padding(reader.frames, window_length, step)
    return pad_front, t


def _frames_in(samples: torch.Tensor, window_length: int, step: int) -> int:
    return (samples.shape[-1] - (window_length - step)) // step


def _window(window, device) -> torch.Tensor:
    from zaftpu_torch.core import validate as _validate

    win = _validate.check_window(torch.as_tensor(np.asarray(window)))
    return win.to(device=_device(device), dtype=torch.float32)


def _analysis(path, win: torch.Tensor, step: int, rows, block_frames: int,
              checkpoint_dir, device, progress, prefetch,
              stats) -> np.ndarray:
    """``(F, T)``: ``rows(samples, number_times)`` over the file's blocks at
    the STFT geometry of ``win`` and ``step``."""
    from zaftpu_torch.core import validate as _validate

    wl = win.shape[0]
    step = _validate.check_step(step, wl)
    pad_front, t = _frame_plan(path, wl, step)
    st = StreamingTransform(
        path, wl, step, pad_front, t,
        lambda samples: rows(samples, _frames_in(samples, wl, step)),
        block_frames, checkpoint_dir, device)
    return st.run(progress, prefetch, stats).T


def streaming_spectrogram(path, window, step: int, block_frames: int = 4096,
                          checkpoint_dir: str | None = None, device="cuda",
                          progress=None, prefetch: int = 2,
                          stats: StreamStats | None = None):
    """Magnitude spectrogram ``(WL/2, T)`` of an arbitrarily long WAV over
    bins 1..WL/2 (the reference's convention), in resumable blocks, each
    block by :func:`zaftpu_torch.spectrogram`'s route (the real-FFT
    kernel's magnitude store where its rule holds)."""
    from zaftpu_torch.transforms.stft import spectrogram_rows

    win = _window(window, device)
    return _analysis(
        path, win, step,
        lambda s, b: spectrogram_rows(s, win, step, b),
        block_frames, checkpoint_dir, device, progress, prefetch, stats)


def streaming_melspectrogram(path, window, step: int, mel_filterbank,
                             block_frames: int = 4096,
                             checkpoint_dir: str | None = None,
                             device="cuda", progress=None,
                             prefetch: int = 2,
                             stats: StreamStats | None = None):
    """Mel spectrogram ``(M, T)`` of an arbitrarily long WAV, resumable,
    each block by :func:`zaftpu_torch.melspectrogram`'s route (the mel
    store where the rule holds)."""
    from zaftpu_torch.features.mel import mel_rows_padded
    from zaftpu_torch.kernels.melfft import as_dense

    win = _window(window, device)
    fbank = as_dense(mel_filterbank)
    return _analysis(
        path, win, step,
        lambda s, b: mel_rows_padded(s, win, fbank, step, b, power=False),
        block_frames, checkpoint_dir, device, progress, prefetch, stats)


def streaming_mfcc(path, window, step: int, mel_filterbank,
                   number_coefficients: int, block_frames: int = 4096,
                   checkpoint_dir: str | None = None, device="cuda",
                   progress=None, prefetch: int = 2,
                   stats: StreamStats | None = None):
    """MFCCs ``(number_coefficients, T)`` of an arbitrarily long WAV,
    resumable: the zaf.py:378-454 chain (power-mel rows by
    :func:`zaftpu_torch.mfcc`'s route, ``log(+eps)``, orthonormal DCT-II,
    coefficients 1..C) a frame block at a time."""
    from zaftpu_torch.features.mel import cepstra, mel_rows_padded
    from zaftpu_torch.kernels.melfft import as_dense

    win = _window(window, device)
    fbank = as_dense(mel_filterbank)
    c = int(number_coefficients)
    return _analysis(
        path, win, step,
        lambda s, b: cepstra(
            mel_rows_padded(s, win, fbank, step, b, power=True),
            fbank.shape[0], c),
        block_frames, checkpoint_dir, device, progress, prefetch, stats)


def streaming_mdct(path, window, block_frames: int = 4096,
                   checkpoint_dir: str | None = None, device="cuda",
                   progress=None, prefetch: int = 2,
                   stats: StreamStats | None = None):
    """MDCT ``(WL/2, T)`` of an arbitrarily long WAV, resumable.

    The reference's geometry (zaf.py:984-1075): hop ``WL/2``, ``T =
    ceil(N/(WL/2)) + 1``, ``WL/2`` zeros in front. Each block by
    :func:`zaftpu_torch.mdct`'s route: the fast MDCT kernel where its rule
    holds, B2 (its twin on a lowered dial) elsewhere."""
    from zaftpu_torch.core import validate as _validate
    from zaftpu_torch.transforms.mdct import mdct_rows

    win = _validate.check_window(torch.as_tensor(np.asarray(window)),
                                 even=True).to(device=_device(device),
                                               dtype=torch.float32)
    wl = win.shape[0]
    step = wl // 2
    reader = BlockReader(path, block_samples=1)
    t = int(np.ceil(reader.frames / step)) + 1
    st = StreamingTransform(
        path, wl, step, step, t,
        lambda s: mdct_rows(s, win, _frames_in(s, wl, step)),
        block_frames, checkpoint_dir, device)
    return st.run(progress, prefetch, stats).T


def streaming_cqtspectrogram(path, sampling_frequency, time_resolution,
                             cqt_kernel, block_frames: int = 256,
                             checkpoint_dir: str | None = None,
                             device="cuda", progress=None,
                             prefetch: int = 2,
                             stats: StreamStats | None = None):
    """CQT spectrogram ``(F, T)`` of an arbitrarily long WAV, resumable.

    The reference's geometry (zaf.py:602-620): hop
    ``round(sr/time_resolution)``, each frame ``fft_length`` samples long,
    the asymmetric centring pad. Each block by
    :func:`zaftpu_torch.cqtspectrogram`'s route (the spectral kernel at a
    power-of-two length up to 131,072)."""
    from zaftpu_torch.transforms import cqt as _cqt

    kern = _cqt._as_kernel(cqt_kernel)
    step = round(float(sampling_frequency) / float(time_resolution))
    length = kern.fft_length
    reader = BlockReader(path, block_samples=1)
    t = reader.frames // step
    if t < 1:
        raise ValueError("signal shorter than one CQT hop")
    pad_front = int(np.ceil((length - step) / 2))
    st = StreamingTransform(
        path, length, step, pad_front, t,
        lambda s: _cqt.cqt_rows(s, kern, step, _frames_in(s, length, step)),
        block_frames, checkpoint_dir, device)
    return st.run(progress, prefetch, stats).T


class StreamingSynthesis:
    """Drive block-wise overlap-add synthesis into a WAV file, resumably.

    The synthesis twin of :class:`StreamingTransform`: coefficient columns
    come in blocks through the same pinned upload, each block's
    overlap-add runs on the device, and the ``overlap`` trailing samples
    (partial sums reaching into the next block) are carried on the host
    into the next block. Samples stream to a
    :class:`~zaftpu_torch.io.wavstream.StreamingWavWriter`.

    Failure recovery: after each block the carry and the output position
    are checkpointed (atomic replace); a restarted job truncates the WAV to
    the checkpoint and resumes at the next block.

    Args:
        number_times: total coefficient columns T.
        fetch: ``(first_col, last_col) -> host array`` (a view of a numpy
            array or ``np.memmap`` will do): the block's input, copied into
            a pinned buffer and uploaded.
        block_fn: ``(uploaded input) -> time samples (n_cols*step +
            overlap,)``, the block's internal overlap-add, on ``device``.
        step: synthesis hop in samples.
        overlap: carried tail length (``window_length - step``).
        trim_front: samples dropped from the stream's head.
        target_len: output length after trimming.
        writer: open :class:`StreamingWavWriter`.
        block_frames: coefficient columns per block.
        checkpoint_dir: directory for resume state (None: no resume).
        device: ``"cuda"`` by default; without a card that raises.

    :attr:`stats` holds the last run's time split.
    """

    _STATE = "synthesis_state.npz"

    def __init__(self, number_times: int, fetch, block_fn, step: int,
                 overlap: int, trim_front: int, target_len: int, writer,
                 block_frames: int = 4096,
                 checkpoint_dir: str | None = None, device="cuda"):
        self.device = _device(device)
        self.number_times = int(number_times)
        self.fetch = fetch
        self.block_fn = block_fn
        self.step = int(step)
        self.overlap = int(overlap)
        self.trim_front = int(trim_front)
        self.target_len = int(target_len)
        self.writer = writer
        self.block_frames = int(block_frames)
        self.checkpoint_dir = checkpoint_dir
        self.stats = StreamStats()
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)

    @property
    def num_blocks(self) -> int:
        return -(-self.number_times // self.block_frames)

    def _state_path(self) -> str:
        return os.path.join(self.checkpoint_dir, self._STATE)

    def _emit(self, chunk: np.ndarray, pos: int) -> None:
        """Write the part of untrimmed-stream samples ``[pos, pos+len)``
        inside ``[trim_front, trim_front+target_len)``."""
        lo = max(pos, self.trim_front)
        hi = min(pos + chunk.shape[0], self.trim_front + self.target_len)
        if hi > lo:
            self.writer.append(chunk[lo - pos:hi - pos])

    def run(self, progress=None, stats: StreamStats | None = None) -> int:
        """All blocks, resuming from the checkpoint; returns the frames
        written. Block ``k+1`` is queued before block ``k`` is fetched.
        :attr:`stats` (and ``stats``, if given) holds the run's time
        split."""
        first_block = 0
        carry = None
        pos = 0  # untrimmed-stream position of the next emit
        if self.checkpoint_dir and os.path.exists(self._state_path()):
            state = np.load(self._state_path())
            first_block = int(state["next_block"])
            carry = state["carry"]
            pos = int(state["pos"])
            self.writer.truncate(int(state["written"]))
        stage = _Stage(self.device, 2, stats)

        def dispatch(index: int):
            first = index * self.block_frames
            last = min(first + self.block_frames, self.number_times)
            t0 = time.perf_counter()
            cols = np.asarray(self.fetch(first, last))
            slot, host = stage.host_buffer(cols.shape, cols.dtype)
            np.copyto(host, cols)
            stage.stats.read_s += time.perf_counter() - t0
            x = stage.upload(slot, host)
            return stage.fetch(slot, stage.compute(slot, self.block_fn, x))

        pending = (dispatch(first_block)
                   if first_block < self.num_blocks else None)
        for index in range(first_block, self.num_blocks):
            first = index * self.block_frames
            last = min(first + self.block_frames, self.number_times)
            handle = pending
            pending = (dispatch(index + 1)
                       if index + 1 < self.num_blocks else None)
            block = np.array(stage.wait(handle))
            if carry is not None and carry.shape[0]:
                block[:self.overlap] += carry.astype(block.dtype)
            if last == self.number_times:  # the final block: flush the tail
                emit_n = block.shape[0]
                carry = np.zeros(0, dtype=block.dtype)
            else:
                emit_n = (last - first) * self.step
                carry = block[emit_n:]
            self._emit(block[:emit_n], pos)
            pos += emit_n
            stage.stats.blocks += 1
            stage.stats.frames += last - first
            if self.checkpoint_dir:
                tmp = self._state_path() + f".tmp{os.getpid()}.npz"
                np.savez(tmp, next_block=index + 1, carry=carry, pos=pos,
                         written=self.writer.frames_written)
                os.replace(tmp, self._state_path())
            if progress:
                progress(index, self.num_blocks)
        self.stats = stage.finish()
        return self.writer.frames_written


def _synthesis(out_path, sampling_frequency, t, fetch, block_fn, step,
               overlap, trim_front, target_len, block_frames,
               checkpoint_dir, device, progress, stats) -> int:
    resume = bool(checkpoint_dir) and os.path.exists(
        os.path.join(checkpoint_dir, StreamingSynthesis._STATE))
    with StreamingWavWriter(out_path, sampling_frequency,
                            resume=resume) as writer:
        synth = StreamingSynthesis(
            t, fetch, block_fn, step, overlap, trim_front, target_len,
            writer, block_frames, checkpoint_dir, device)
        return synth.run(progress, stats)


def streaming_istft(audio_stft, window, step: int, out_path,
                    sampling_frequency: int, block_frames: int = 4096,
                    checkpoint_dir: str | None = None, device="cuda",
                    progress=None,
                    stats: StreamStats | None = None) -> int:
    """Inverse STFT streamed to a float32 WAV file, resumable.

    ``audio_stft`` is the full complex ``(WL, T)`` spectrum (reference
    zaf.py:144-243), e.g. an ``np.memmap`` or ``np.load(...,
    mmap_mode="r")`` of an hour's spectrogram; its columns are inverted a
    block at a time by :func:`zaftpu_torch.istft`'s route (the inverse
    real-FFT + overlap-add kernel where the rule holds) and overlap-added
    across blocks through the carried halo. Returns the samples written
    (``T*step - window_length + step``)."""
    from zaftpu_torch import kernels as _kernels
    from zaftpu_torch.core import frame as _frame
    from zaftpu_torch.core import validate as _validate

    window = np.asarray(_validate.check_window(np.asarray(window)))
    wl = len(window)
    step = _validate.check_step(step, wl)
    if audio_stft.shape[0] != wl:
        raise ValueError(f"audio_stft must have {wl} rows, got "
                         f"{audio_stft.shape[0]}")
    t = int(audio_stft.shape[1])
    gain = _frame.cola_gain(window, step)
    _validate.check_cola(window, step, gain)

    def block_fn(cols):
        _kernels.check_device_input(cols)
        return _kernels.synthesis_ola(cols, step, gain)

    return _synthesis(out_path, sampling_frequency, t,
                      lambda a, b: audio_stft[:, a:b], block_fn, step,
                      wl - step, wl - step, t * step - wl + step,
                      block_frames, checkpoint_dir, device, progress, stats)


def streaming_imdct(audio_mdct, window, out_path, sampling_frequency: int,
                    block_frames: int = 4096,
                    checkpoint_dir: str | None = None, device="cuda",
                    progress=None,
                    stats: StreamStats | None = None) -> int:
    """Inverse MDCT (TDAC) streamed to a float32 WAV file, resumable.

    ``audio_mdct`` is the ``(F, T)`` coefficient matrix (reference
    zaf.py:1078-1184); each block runs :func:`zaftpu_torch.imdct`'s route
    (the fast IMDCT + overlap-add kernel where its rule holds, B7 or its
    twin elsewhere) and carries ``F`` halo samples into the next. Returns
    the samples written (``F*(T+1) - 2F - 1``)."""
    from zaftpu_torch import kernels as _kernels
    from zaftpu_torch.transforms.mdct import imdct_signal

    window = np.asarray(window, dtype=np.float64)
    f = int(audio_mdct.shape[0])
    if len(window) != 2 * f:
        raise ValueError(f"window length must be 2*number_frequencies = "
                         f"{2 * f}, got {len(window)}")
    t = int(audio_mdct.shape[1])

    def block_fn(coeffs):
        coeffs = coeffs.to(torch.promote_types(coeffs.dtype, torch.float32))
        _kernels.check_device_input(coeffs)
        return imdct_signal(coeffs, window)

    return _synthesis(out_path, sampling_frequency, t,
                      lambda a, b: audio_mdct[:, a:b].T, block_fn, f, f, f,
                      f * (t + 1) - 2 * f - 1, block_frames, checkpoint_dir,
                      device, progress, stats)
