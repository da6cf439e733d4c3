"""The magnitude and mel front ends: CUDA kernels (``csrc/melfused.cu``) and
their plain versions.

``spec_rows`` replaces ``zaftpu/pallas/melfused.py: _spec_rows_impl`` (the
one-pass magnitude spectrogram) and ``mel_rows`` its ``_mel_rows_impl``
(framing, rDFT, magnitude or power, and the filterbank GEMM in one pass).
Both compute the rDFT over bins ``1..WL/2`` only (DC dropped, Nyquist kept,
zaf.py:370). The magnitude is ``sqrt(re² + im²)`` in the kernels and in
the plain versions alike, not complex ``abs``, which may round otherwise at
the last ulp. The filterbank GEMM is full FP32, as ``zaftpu`` runs it at
HIGHEST in every precision mode.

``ZAFTPU_MELFUSE=0`` is ``zaftpu``'s A/B lever: ``spectrogram``,
``melspectrogram`` and ``mfcc`` then take the split path (the half spectrum
from the analysis dispatch, ``|·|`` and ``exact_matmul``).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core.frame import extract_frames
from zaftpu_torch.core.policy import exact_matmul
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels.framing import check_frame_args
from zaftpu_torch.kernels.fused import (TILE_BINS, TILE_FRAMES,
                                        padded_cols)

CUDA_SOURCE = "zaftpu_torch/csrc/melfused.cu"
REPLACES_SPEC = "zaftpu/pallas/melfused.py:200"  # _spec_rows_impl
REPLACES_MEL = "zaftpu/pallas/melfused.py:263"   # _mel_rows_impl


def enabled() -> bool:
    """``ZAFTPU_MELFUSE``: on unless ``0`` (``zaftpu``'s A/B lever)."""
    return os.environ.get("ZAFTPU_MELFUSE", "auto") != "0"


def kernel_wanted() -> bool:
    """Take the one-pass kernels? Yes unless ``ZAFTPU_MELFUSE=0``. Unlike
    ``zaftpu``'s there is no hop, rank or operator-size condition: the
    kernels take any hop up to WL and any batch, and the operator lives in
    device memory."""
    return enabled()


@lru_cache(maxsize=8)
def _spec_ops(n: int, rdtype_name: str = "float32") -> np.ndarray:
    """``(2, N, F_pad)`` cos/sin operator of bins ``1..N/2`` in columns
    ``0..N/2-1``, zero columns to whole 64-column tiles: ``zaftpu``'s
    ``_rdft_ops_padded`` without its DC column."""
    cos_m, sin_m = _fft._direct_rdft_mats(n, rdtype_name)
    f = n // 2
    ops = np.zeros((2, n, padded_cols(f)), rdtype_name)
    ops[0, :, :f] = cos_m[:, 1:f + 1]
    ops[1, :, :f] = sin_m[:, 1:f + 1]
    return ops


def spec_ops(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    return _fft.device_operator(_spec_ops, (n, _fft._real_name(dtype)),
                                torch.device(device), dtype)


def _planes(padded, window, window_length, step, number_times, ops):
    """Re and im of bins ``1..WL/2`` of the windowed frames, plain."""
    frames = (extract_frames(padded, window_length, step, number_times)
              * window.to(padded.dtype))
    if ops is None:
        ops = spec_ops(window_length, padded.dtype, padded.device)
    f = window_length // 2
    return (exact_matmul(frames, ops[0, :, :f]),
            exact_matmul(frames, ops[1, :, :f]))


def spec_rows_plain(padded: torch.Tensor, window: torch.Tensor,
                    window_length: int, step: int, number_times: int,
                    ops: torch.Tensor | None = None) -> torch.Tensor:
    """``sqrt(re² + im²)`` over bins ``1..WL/2``, ``(..., T, WL/2)``, in
    plain PyTorch."""
    spec_rows_plain.calls += 1
    re, im = _planes(padded, window, window_length, step, number_times, ops)
    return torch.sqrt(re * re + im * im)


spec_rows_plain.calls = 0


def spec_rows(padded: torch.Tensor, window: torch.Tensor, window_length: int,
              step: int, number_times: int,
              ops: torch.Tensor | None = None) -> torch.Tensor:
    """One-pass magnitude spectrogram rows ``(..., T, WL/2)`` over bins
    ``1..WL/2`` of a padded signal ``(..., L)``; neither the frames nor the
    half spectrum are stored. ``ops`` overrides the ``(2, WL, F_pad)``
    operator (:func:`spec_ops`).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not padded.is_cuda:
        return spec_rows_plain(padded, window, window_length, step,
                               number_times, ops)
    return _spec_rows_cuda(padded, window, window_length, step,
                           number_times, ops)


def _device_args(name, padded, window, window_length, step, number_times,
                 ops):
    """Check a CUDA input; return the flattened signal, window and
    operator as the kernels take them."""
    check_frame_args(name, padded, window, window_length, step,
                     number_times)
    wl = window_length
    fp = padded_cols(wl // 2)
    if ops is None:
        ops = spec_ops(wl, torch.float32, padded.device)
    if ops.shape != (2, wl, fp) or ops.dtype != torch.float32:
        raise ValueError(f"{name}: operator must be float32 (2, {wl}, {fp}), "
                         f"got {ops.dtype} {tuple(ops.shape)}")
    sig = padded.reshape(-1, padded.shape[-1]).contiguous()
    _build.require_grid(sig.shape[0], -(-number_times // TILE_FRAMES), name)
    win = window.to(device=padded.device, dtype=torch.float32).contiguous()
    return sig, win, ops.to(padded.device).contiguous(), fp


def _spec_rows_cuda(padded: torch.Tensor, window: torch.Tensor,
                    window_length: int, step: int, number_times: int,
                    ops: torch.Tensor | None = None) -> torch.Tensor:
    """Check the CUDA input, launch the kernel, count the launch."""
    sig, win, ops, fp = _device_args("spec_rows", padded, window,
                                     window_length, step, number_times, ops)
    wl, t, f = window_length, number_times, window_length // 2
    out = torch.empty((sig.shape[0], t, f), dtype=torch.float32,
                      device=padded.device)
    err = _build.library().zt_spec_rows(
        sig.data_ptr(), win.data_ptr(), ops.data_ptr(), out.data_ptr(),
        sig.shape[0], sig.shape[-1], t, wl, step, f, fp,
        _build.stream_of(padded))
    _build.check(err, "zt_spec_rows")
    spec_rows.launches += 1
    return out.reshape(*padded.shape[:-1], t, f)


spec_rows.launches = 0


def mel_rows_plain(padded: torch.Tensor, window: torch.Tensor,
                   fbank_t: torch.Tensor, window_length: int, step: int,
                   number_times: int, power: bool,
                   ops: torch.Tensor | None = None) -> torch.Tensor:
    """Magnitude (``power=False``) or power (``power=True``) over bins
    ``1..WL/2`` times the ``(WL/2, n_mels)`` filterbank transpose,
    ``(..., T, n_mels)``, in plain PyTorch."""
    mel_rows_plain.calls += 1
    re, im = _planes(padded, window, window_length, step, number_times, ops)
    p2 = re * re + im * im
    return exact_matmul(p2 if power else torch.sqrt(p2),
                        fbank_t.to(padded.dtype))


mel_rows_plain.calls = 0


def mel_rows(padded: torch.Tensor, window: torch.Tensor,
             fbank_t: torch.Tensor, window_length: int, step: int,
             number_times: int, power: bool,
             ops: torch.Tensor | None = None) -> torch.Tensor:
    """One-pass mel front end: ``(..., T, n_mels)`` magnitude-mel
    (``power=False``, melspectrogram) or power-mel (``power=True``, the
    MFCC front) rows of a padded signal ``(..., L)``. ``fbank_t``: the
    ``(WL/2, n_mels)`` filterbank transpose. ``ops`` overrides the
    operator (:func:`spec_ops`).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises. The kernel stages a
    bin tile's ``(64, n_mels)`` filterbank rows in shared memory, so the
    card's shared memory per block bounds ``n_mels`` (about 740 on an
    H100); above that the launch raises.
    """
    if not padded.is_cuda:
        return mel_rows_plain(padded, window, fbank_t, window_length, step,
                              number_times, power, ops)
    return _mel_rows_cuda(padded, window, fbank_t, window_length, step,
                          number_times, power, ops)


def _mel_rows_cuda(padded: torch.Tensor, window: torch.Tensor,
                   fbank_t: torch.Tensor, window_length: int, step: int,
                   number_times: int, power: bool,
                   ops: torch.Tensor | None = None) -> torch.Tensor:
    """Check the CUDA input, launch the kernels, count the launch."""
    f = window_length // 2
    if fbank_t.ndim != 2 or fbank_t.shape[0] != f or fbank_t.shape[1] < 1:
        raise ValueError(f"mel_rows: filterbank transpose must be ({f}, "
                         f"n_mels) with n_mels >= 1, got "
                         f"{tuple(fbank_t.shape)}")
    _build.require_f32(fbank_t, "mel_rows")
    sig, win, ops, fp = _device_args("mel_rows", padded, window,
                                     window_length, step, number_times, ops)
    t, m, batch = number_times, fbank_t.shape[1], sig.shape[0]
    fbt = fbank_t.to(padded.device).contiguous()
    tiles = fp // TILE_BINS  # each writes a partial; a second pass sums them
    dev = padded.device
    part = (torch.empty((tiles, batch, t, m), dtype=torch.float32, device=dev)
            if tiles > 1 else None)
    out = torch.empty((batch, t, m), dtype=torch.float32, device=dev)
    err = _build.library().zt_mel_rows(
        sig.data_ptr(), win.data_ptr(), ops.data_ptr(), fbt.data_ptr(),
        None if part is None else part.data_ptr(), out.data_ptr(), batch,
        sig.shape[-1], t, window_length, step, f, fp, m, int(power),
        _build.stream_of(padded))
    _build.check(err, "zt_mel_rows")
    mel_rows.launches += 1
    return out.reshape(*padded.shape[:-1], t, m)


mel_rows.launches = 0
