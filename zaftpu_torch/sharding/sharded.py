"""Frame-block-sharded transforms: the long-audio scaling path.

The port of ``zaftpu.sharding.sharded`` on ``torch.distributed``. Each
analysis shards one long signal (or a batch of them) by contiguous frame
blocks over the mesh's ``"frames"`` axis; each synthesis shards the frame
axis of its coefficients. The only communication is the halo exchange of
:mod:`zaftpu_torch.sharding.halo`.

The contract:

* SPMD. One process runs per device, and every rank of the mesh calls a
  sharded function with the same whole input, which plays the part of
  ``zaftpu``'s global array. Each rank cuts its own body block from it
  locally; nothing is scattered.
* Outputs. A function returns this rank's block along the sharded axis as
  a plain tensor on the rank's device: time for the analyses, samples for
  the syntheses, channels for :func:`cqtspectrogram_tp`, and on a 2-D mesh
  (:func:`zaftpu_torch.sharding.make_mesh_2d`) only this rank's rows of a
  batched input's first axis. :func:`zaftpu_torch.sharding.gather` gives
  the whole, which equals ``zaftpu``'s sharded and unsharded results.
  The blocks are ``zaftpu``'s layout: the analyses pad the frame count to
  ``t_pad``, a multiple of the frame-axis size large enough that all of the
  signal lies inside the sharded body, give each rank ``t_pad / n`` frames
  and trim to the true count, so the last ranks' blocks are shorter or
  empty. That is not the uneven ``torch.chunk`` layout ``DTensor``
  assumes, so no ``DTensor`` is used.
* Synthesis inputs. :func:`istft_sharded` and :func:`imdct_sharded` take
  the whole coefficients, or with ``block=True`` this rank's block as
  :func:`stft_sharded` / :func:`mdct_sharded` returned it, so a round trip
  gathers nothing in between.
* Devices. A CPU tensor needs a gloo mesh and a CUDA tensor an NCCL one;
  a non-tensor input goes to the rank's card as float32 (complex64 for a
  spectrum), as the unsharded transforms send it. Any mismatch raises.
* Block bodies are the port's own row functions, the streaming pipeline's
  block bodies: each shard runs the same dispatch, and so the same
  kernels, as the unsharded transform (``windowed_frames_rfft_fullspec``,
  ``spectrogram_rows``, ``mel_rows_padded`` and ``cepstra``,
  ``mdct_rows``, ``synthesis_ola``, ``imdct_signal``, ``cqt_rows`` and
  ``_octave_fold``). A kernel failure raises; nothing falls back.

Geometry invariant: the sharded body covers ``t_pad * step`` samples and
all of the signal lies inside it, so the zeros a rank past the edge sends
are exact, and the surplus frames are dropped at the end. ``zaftpu``'s
``ZAFTPU_SHARDED_FUSE`` and ``ZAFTPU_BUCKET_FRAMES`` choose how many jit
traces it builds (their values are bit-identical either way); without a
tracer they mean nothing, and the port takes its fused mode's exact
``t_pad``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from zaftpu_torch import kernels as _kernels
from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core import frame as _frame
from zaftpu_torch.features import mel as _mel
from zaftpu_torch.sharding import halo as _halo
from zaftpu_torch.sharding.mesh import (BATCH_AXIS, FRAME_AXIS, axis_group,
                                        block_bounds, block_lengths,
                                        mesh_device)
from zaftpu_torch.transforms import cqt as _cqt
from zaftpu_torch.transforms import mdct as _mdct
from zaftpu_torch.transforms import stft as _stft


class _Place(NamedTuple):
    """This rank's place on a mesh: the frame axis's group, its size and
    this rank's index on it, the batch axis's group (None without one) and
    the rank's device."""

    group: object
    n: int
    index: int
    batch: object
    device: torch.device


def _place(mesh, axis_name: str) -> _Place:
    group = axis_group(mesh, axis_name)
    names = mesh.mesh_dim_names or ()
    batch = (axis_group(mesh, BATCH_AXIS)
             if BATCH_AXIS in names and axis_name != BATCH_AXIS else None)
    return _Place(group, dist.get_world_size(group), dist.get_rank(group),
                  batch, mesh_device(mesh))


def _on_mesh(x, place: _Place) -> torch.Tensor:
    """``x`` as a tensor on the rank's device type: a tensor as is, anything
    else sent to the card (:func:`zaftpu_torch.transforms.stft._as_input`);
    a tensor on the other device type raises."""
    x = _stft._as_input(x)
    if x.device.type != place.device.type:
        raise ValueError(
            f"a {x.device.type} input on a {place.device.type} mesh: a CPU "
            "tensor needs a gloo mesh, a CUDA tensor an NCCL one")
    return x


def _batch_rows(x: torch.Tensor, place: _Place,
                core_dims: int) -> torch.Tensor:
    """This rank's rows of ``x``'s first axis when the mesh has a batch
    axis and ``x`` has leading axes before its ``core_dims`` last ones
    (``zaftpu``'s ``_batch_spec``); ``x`` otherwise."""
    if place.batch is None or x.ndim <= core_dims:
        return x
    nb = dist.get_world_size(place.batch)
    if x.shape[0] % nb:
        raise ValueError(
            f"a batch of {x.shape[0]} does not split over the mesh's "
            f"{nb}-way batch axis")
    rows = x.shape[0] // nb
    lo = dist.get_rank(place.batch) * rows
    return x[lo:lo + rows]


def _plan_body(number_samples: int, pad_front: int, step: int,
               number_times: int, n_shards: int) -> int:
    """``t_pad``: at least ``number_times``, a multiple of ``n_shards``,
    and ``t_pad * step >= pad_front + number_samples``, so that the halo
    beyond the sharded body is zero padding (``zaftpu``'s fused mode)."""
    t_min = max(number_times, -(-(pad_front + number_samples) // step))
    return n_shards * (-(-t_min // n_shards))


def _cut(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``x[..., lo:hi]`` with zeros where ``[lo, hi)`` leaves the signal."""
    a, b = max(lo, 0), min(hi, x.shape[-1])
    if a >= b:
        return x.new_zeros(x.shape[:-1] + (hi - lo,))
    if (a, b) == (lo, hi):
        return x[..., lo:hi]
    return torch.nn.functional.pad(x[..., a:b], (a - lo, hi - b))


def _analysis(x: torch.Tensor, place: _Place, pad_front: int, step: int,
              overlap: int, number_times: int, rows) -> torch.Tensor:
    """This rank's rows ``(..., t_keep, F)`` of a frame-local analysis of
    ``x``: its ``t_pad / n``-frame body block of the signal padded by
    ``pad_front`` in front, the first ``overlap`` samples of its right
    neighbours' blocks pulled after it, ``rows(extended, t_local)``, and
    only the frames below ``number_times`` kept."""
    t_pad = _plan_body(x.shape[-1], pad_front, step, number_times, place.n)
    t_local = t_pad // place.n
    lo = place.index * t_local * step - pad_front
    block = _cut(x, lo, lo + t_local * step)
    extended = _halo.pull_from_right(block, overlap, place.group)
    keep = max(0, min(t_local, number_times - place.index * t_local))
    return rows(extended, t_local)[..., :keep, :]


def _synthesis_columns(c: torch.Tensor, place: _Place,
                       block: bool) -> tuple[torch.Tensor, int, int]:
    """This rank's coefficient columns ``(..., F, t_local)`` (zero columns
    past the last frame), the whole frame count ``T`` and ``t_local``,
    from the whole ``(..., F, T)`` coefficients or (``block``) this rank's
    block of an analysis's output."""
    if block:
        lengths = block_lengths(c.shape[-1], place.group, place.device)
        t, t_local = sum(lengths), lengths[0]
        if any(length != max(0, min(t_local, t - i * t_local))
               for i, length in enumerate(lengths)):
            raise ValueError(
                f"block lengths {lengths} along the frame axis are not an "
                "analysis's layout (the first ranks' blocks equal, then a "
                "shorter one, then empty ones)")
        local = c
    else:
        t = c.shape[-1]
        t_local = -(-t // place.n)
        lo, hi = block_bounds(t, place.n, place.index)
        local = c[..., lo:hi]
    short = t_local - local.shape[-1]
    if short:
        local = torch.cat(
            [local, local.new_zeros(local.shape[:-1] + (short,))], dim=-1)
    return local, t, t_local


def _synthesis_block(signal: torch.Tensor, body_len: int, place: _Place,
                     trim_front: int, length: int) -> torch.Tensor:
    """This rank's samples of ``[trim_front, trim_front + length)`` of the
    whole overlap-add, from its local overlap-add ``signal`` (its
    ``body_len`` body samples, then the spill into the right
    neighbours'), after the boundary sums."""
    body = _halo.push_right_sum(signal[..., :body_len],
                                signal[..., body_len:], place.group)
    start = place.index * body_len
    lo = min(max(trim_front - start, 0), body_len)
    hi = min(max(trim_front + length - start, 0), body_len)
    return body[..., lo:hi]


# ---------------------------------------------------------------------------
# STFT family
# ---------------------------------------------------------------------------

def _stft_inputs(audio_signal, window_function, step_length, mesh,
                 axis_name):
    place = _place(mesh, axis_name)
    x, win, step = _stft._analysis_inputs(_on_mesh(audio_signal, place),
                                          window_function, step_length, None)
    x = _batch_rows(x, place, 1)
    pad_front, _, t = _frame.stft_padding(x.shape[-1], win.shape[0], step)
    return place, x, win, step, pad_front, t


def stft_sharded(audio_signal, window_function, step_length: int, mesh,
                 axis_name: str = FRAME_AXIS) -> torch.Tensor:
    """Frame-block-sharded STFT: this rank's columns ``(...,
    window_length, t_keep)`` of :func:`zaftpu_torch.stft`'s output. Each
    rank pulls a ``window_length - step`` halo from its right neighbour
    and runs the analysis kernel on its block."""
    place, x, win, step, pad_front, t = _stft_inputs(
        audio_signal, window_function, step_length, mesh, axis_name)
    wl = win.shape[0]

    def rows(extended, t_local):
        full = _kernels.windowed_frames_rfft_fullspec(extended, win, wl,
                                                      step, t_local)
        if full is None:
            return _kernels.windowed_frames_rfft(extended, win, wl, step,
                                                 t_local)
        return full

    out = _analysis(x, place, pad_front, step, wl - step, t, rows)
    if out.shape[-1] != wl:
        out = _fft.full_from_half(out, wl)
    return out.transpose(-1, -2)


def spectrogram_sharded(audio_signal, window_function, step_length: int,
                        mesh, axis_name: str = FRAME_AXIS) -> torch.Tensor:
    """Sharded magnitude spectrogram over bins ``1..WL/2``: this rank's
    columns ``(..., WL/2, t_keep)``."""
    place, x, win, step, pad_front, t = _stft_inputs(
        audio_signal, window_function, step_length, mesh, axis_name)
    out = _analysis(x, place, pad_front, step, win.shape[0] - step, t,
                    lambda ext, tl: _stft.spectrogram_rows(ext, win, step,
                                                           tl))
    return out.transpose(-1, -2)


def istft_sharded(audio_stft, window_function, step_length: int, mesh,
                  axis_name: str = FRAME_AXIS, *,
                  block: bool = False) -> torch.Tensor:
    """Frame-block-sharded inverse STFT: this rank's samples of
    :func:`zaftpu_torch.istft`'s output. Each rank overlap-adds its
    columns, then sends the ``window_length - step`` samples that spill
    into its right neighbour's region, where they are summed.

    ``audio_stft``: the whole ``(..., WL, T)`` spectrum, or with ``block``
    this rank's block as :func:`stft_sharded` returned it."""
    place = _place(mesh, axis_name)
    z, step, gain = _stft._synthesis_inputs(_on_mesh(audio_stft, place),
                                            window_function, step_length,
                                            None)
    if not block:
        z = _batch_rows(z, place, 2)
    cols, t, t_local = _synthesis_columns(z, place, block)
    wl = z.shape[-2]
    signal = _kernels.synthesis_ola(cols, step, gain)
    edge = wl - step
    return _synthesis_block(signal, t_local * step, place, edge,
                            t * step - edge)


# ---------------------------------------------------------------------------
# Mel features
# ---------------------------------------------------------------------------

def _mel_sharded(audio_signal, window_function, step_length, mel_filterbank,
                 mesh, axis_name, mfcc: bool, number_coefficients=None):
    """This rank's columns ``(..., n_mels, t_keep)`` of the mel
    spectrogram, or (``mfcc``) ``(..., C, t_keep)`` of the MFCCs."""
    place = _place(mesh, axis_name)
    x, win, step, fbank = _mel._inputs(_on_mesh(audio_signal, place),
                                       window_function, step_length,
                                       mel_filterbank, None)
    if mfcc:
        number_coefficients = _mel.check_coefficients(number_coefficients,
                                                      fbank.shape[0])
    x = _batch_rows(x, place, 1)
    wl = win.shape[0]
    pad_front, _, t = _frame.stft_padding(x.shape[-1], wl, step)
    table = _mel.filterbank_table(x, win, fbank, mfcc)
    rows = _analysis(
        x, place, pad_front, step, wl - step, t,
        lambda ext, tl: _mel.mel_rows_padded(ext, win, fbank, step, tl,
                                             mfcc, table))
    if mfcc:
        rows = _mel.cepstra(rows, fbank.shape[0], number_coefficients)
    return rows.transpose(-1, -2)


def melspectrogram_sharded(audio_signal, window_function, step_length: int,
                           mel_filterbank, mesh,
                           axis_name: str = FRAME_AXIS) -> torch.Tensor:
    """Sharded mel spectrogram: this rank's columns ``(..., number_mels,
    t_keep)``; the filterbank is whole on every rank."""
    return _mel_sharded(audio_signal, window_function, step_length,
                        mel_filterbank, mesh, axis_name, mfcc=False)


def mfcc_sharded(audio_signal, window_function, step_length: int,
                 mel_filterbank, number_coefficients: int, mesh,
                 axis_name: str = FRAME_AXIS) -> torch.Tensor:
    """Sharded MFCCs: this rank's columns ``(..., number_coefficients,
    t_keep)``."""
    return _mel_sharded(audio_signal, window_function, step_length,
                        mel_filterbank, mesh, axis_name, mfcc=True,
                        number_coefficients=number_coefficients)


# ---------------------------------------------------------------------------
# MDCT family
# ---------------------------------------------------------------------------

def mdct_sharded(audio_signal, window_function, mesh,
                 axis_name: str = FRAME_AXIS) -> torch.Tensor:
    """Frame-block-sharded MDCT: this rank's columns ``(..., WL/2,
    t_keep)`` of :func:`zaftpu_torch.mdct`'s output (bfloat16 for a
    bfloat16 signal, as there)."""
    place = _place(mesh, axis_name)
    x, win, in_dtype = _mdct._analysis_inputs(_on_mesh(audio_signal, place),
                                              window_function, None)
    x = _batch_rows(x, place, 1)
    step = win.shape[0] // 2
    t = int(np.ceil(x.shape[-1] / step)) + 1
    # `step` zeros in front (zaf.py:1036-1041).
    out = _analysis(x, place, step, step, step, t,
                    lambda ext, tl: _mdct.mdct_rows(ext, win, tl))
    if in_dtype == torch.bfloat16:
        out = out.to(in_dtype)
    return out.transpose(-1, -2)


def imdct_sharded(audio_mdct, window_function, mesh,
                  axis_name: str = FRAME_AXIS, *,
                  block: bool = False) -> torch.Tensor:
    """Frame-block-sharded inverse MDCT with the TDAC boundary sums: this
    rank's samples of :func:`zaftpu_torch.imdct`'s output, the reference's
    trim included (length ``F*T - F - 1`` in all).

    ``audio_mdct``: the whole ``(..., F, T)`` coefficients, or with
    ``block`` this rank's block as :func:`mdct_sharded` returned it."""
    place = _place(mesh, axis_name)
    c, host_window = _mdct._synthesis_inputs(_on_mesh(audio_mdct, place),
                                             window_function, None)
    if not block:
        c = _batch_rows(c, place, 2)
    cols, t, t_local = _synthesis_columns(c, place, block)
    f = c.shape[-2]
    signal = _mdct.imdct_signal(_mdct.frames_major(cols), host_window)
    out = _synthesis_block(signal, t_local * f, place, f, f * t - f - 1)
    return out.to(c.dtype) if c.dtype == torch.bfloat16 else out


# ---------------------------------------------------------------------------
# CQT family
# ---------------------------------------------------------------------------

def _cqt_inputs(audio_signal, sampling_frequency, time_resolution,
                cqt_kernel, mesh, axis_name):
    place = _place(mesh, axis_name)
    kern = _cqt._as_kernel(cqt_kernel)
    x, step, t = _cqt._cqt_inputs(_on_mesh(audio_signal, place),
                                  sampling_frequency, time_resolution)
    return place, kern, _batch_rows(x, place, 1), step, t


def cqtspectrogram_sharded(audio_signal, sampling_frequency, time_resolution,
                           cqt_kernel, mesh,
                           axis_name: str = FRAME_AXIS) -> torch.Tensor:
    """Frame-block-sharded CQT spectrogram: this rank's columns ``(...,
    number_frequencies, t_keep)`` of :func:`zaftpu_torch.cqtspectrogram`'s
    output, by its route. The halo is ``fft_length - step`` samples (about
    31k at the default kernel), over as many hops as it spans blocks."""
    place, kern, x, step, t = _cqt_inputs(
        audio_signal, sampling_frequency, time_resolution, cqt_kernel, mesh,
        axis_name)
    length = kern.fft_length
    pad_front = int(np.ceil((length - step) / 2))  # zaf.py:613-620
    out = _analysis(x, place, pad_front, step, length - step, t,
                    lambda ext, tl: _cqt.cqt_rows(ext, kern, step, tl))
    return out.transpose(-1, -2)


def cqtchromagram_sharded(audio_signal, sampling_frequency, time_resolution,
                          octave_resolution, cqt_kernel, mesh,
                          axis_name: str = FRAME_AXIS) -> torch.Tensor:
    """Sharded CQT chromagram: this rank's columns ``(...,
    octave_resolution, t_keep)``, the octave fold of its CQT columns."""
    spec = cqtspectrogram_sharded(audio_signal, sampling_frequency,
                                  time_resolution, cqt_kernel, mesh,
                                  axis_name)
    return _cqt._octave_fold(spec, int(octave_resolution))


def cqtspectrogram_tp(audio_signal, sampling_frequency, time_resolution,
                      cqt_kernel, mesh,
                      axis_name: str = FRAME_AXIS) -> torch.Tensor:
    """Tensor-parallel CQT spectrogram: the kernel's channel axis is split
    over ``axis_name`` and the signal is whole on every rank. Rank ``r``
    holds channels ``[r*Fp/n, (r+1)*Fp/n)`` of the ``F`` channels, ``Fp =
    n*ceil(F/n)``, computes every frame for them with no communication,
    and returns its rows ``(..., F_r, number_times)`` of
    :func:`zaftpu_torch.cqtspectrogram`'s output (``gather(..., dim=-2)``
    gives the whole). Frame sharding wins whenever ``T >> F``; this one
    divides the kernel's memory and a short signal's latency."""
    place, kern, x, step, t = _cqt_inputs(
        audio_signal, sampling_frequency, time_resolution, cqt_kernel, mesh,
        axis_name)
    first, last = block_bounds(kern.number_frequencies, place.n, place.index)
    if first == last:
        return x.new_zeros(x.shape[:-1] + (0, t))
    return _cqt._cqt_dispatch(x, _cqt.channel_slice(kern, first, last), step,
                              t, 0)
