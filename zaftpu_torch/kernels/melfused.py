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

The front ends take these kernels at the window lengths the real-FFT
kernel does not cover (:func:`kernel_wanted`); at a power-of-two window
they take its half spectrum, ``|·|`` and the filterbank product, unless
``ZAFTPU_MELFUSE=1`` forces the kernels.

Under ``ZAFTPU_PRECISION=split4`` the front ends leave these kernels for
the split4 half spectrum (:func:`kernel_wanted`), as ``zaftpu``'s do. Forced
with ``ZAFTPU_MELFUSE=1``, ``spec_rows`` stays exact (it has no split4
twin, in ``zaftpu`` either) and ``mel_rows`` takes its split4 twin
``mel_rows_split4``, the port of ``zaftpu``'s ``_kernel_split4``: the rDFT
by four bf16 passes on the tensor cores, the operator presplit on the host,
the filterbank product still FP32.

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
from zaftpu_torch.core.policy import exact_matmul, split4_applies
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import rfft as _rfft
from zaftpu_torch.kernels.framing import check_frame_args
from zaftpu_torch.kernels.fused import (TILE_BINS, TILE_FRAMES, _products,
                                        padded_cols)

CUDA_SOURCE = "zaftpu_torch/csrc/melfused.cu"
REPLACES_SPEC = "zaftpu/pallas/melfused.py:200"  # _spec_rows_impl
REPLACES_MEL = "zaftpu/pallas/melfused.py:263"   # _mel_rows_impl
REPLACES_MEL_SPLIT4 = "zaftpu/pallas/melfused.py:142"  # _kernel_split4


def kernel_wanted(dtype: torch.dtype, window_length: int) -> bool:
    """Take the one-pass kernels for a ``dtype`` signal framed at
    ``window_length``? ``ZAFTPU_MELFUSE=1`` forces them and ``0`` refuses
    them (``zaftpu``'s A/B lever). Otherwise no where split4 applies
    (float32; ``zaftpu``'s gate, melfused.py:87-95: the split4 half
    spectrum carries the front ends) or where the FFT shape rule
    (:func:`zaftpu_torch.kernels.rfft.applies`) gives the half spectrum:
    these kernels run B1's GEMM tile, and the FFT's half spectrum with
    ``|·|`` and one filterbank product is 6.7 to 9 times faster on an H100
    (PERF.md). Yes at any other window. Unlike ``zaftpu``'s there is no
    hop, rank or operator-size condition: the kernels take any hop up to
    WL and any batch, and the operator lives in device memory."""
    melfuse = os.environ.get("ZAFTPU_MELFUSE", "auto")
    if melfuse == "1":
        return True
    if melfuse == "0" or split4_applies(dtype):
        return False
    return not _rfft.applies(window_length)


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


def split4_spec_ops(ops: torch.Tensor | None, n: int,
                    device) -> torch.Tensor:
    """The operator of ``mel_rows``'s twin: ``ops`` (presplit, or float32
    and split on the host), or the cached presplit ``(2, 2, N, F_pad)``
    stack of :func:`_spec_ops`."""
    return _fft.presplit_operator(ops, _spec_ops, (n, "float32"), device)


def _planes(padded, window, window_length, step, number_times, ops):
    """Re and im of bins ``1..WL/2`` of the windowed frames, plain: exact
    for a float operator, by the split4 scheme for a presplit one."""
    frames = (extract_frames(padded, window_length, step, number_times)
              * window.to(padded.dtype))
    if ops is None:
        ops = spec_ops(window_length, padded.dtype, padded.device)
    return _products(frames, ops, window_length // 2)


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
                 ops, split4=False):
    """Check a CUDA input; return the flattened signal, window and
    operator as the kernels take them (``split4``: the presplit one)."""
    check_frame_args(name, padded, window, window_length, step,
                     number_times)
    wl = window_length
    fp = padded_cols(wl // 2)
    if ops is None:
        ops = spec_ops(wl, torch.float32, padded.device)
    shape = (2, 2, wl, fp) if split4 else (2, wl, fp)
    dtype = torch.bfloat16 if split4 else torch.float32
    if tuple(ops.shape) != shape or ops.dtype != dtype:
        raise ValueError(f"{name}: operator must be {dtype} {shape}, got "
                         f"{ops.dtype} {tuple(ops.shape)}")
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


def _mel_plain(padded, window, fbank_t, window_length, step, number_times,
               power, ops):
    re, im = _planes(padded, window, window_length, step, number_times, ops)
    p2 = re * re + im * im
    return exact_matmul(p2 if power else torch.sqrt(p2),
                        fbank_t.to(padded.dtype))


def mel_rows_plain(padded: torch.Tensor, window: torch.Tensor,
                   fbank_t: torch.Tensor, window_length: int, step: int,
                   number_times: int, power: bool,
                   ops: torch.Tensor | None = None) -> torch.Tensor:
    """Magnitude (``power=False``) or power (``power=True``) over bins
    ``1..WL/2`` times the ``(WL/2, n_mels)`` filterbank transpose,
    ``(..., T, n_mels)``, in plain PyTorch."""
    mel_rows_plain.calls += 1
    return _mel_plain(padded, window, fbank_t, window_length, step,
                      number_times, power, ops)


def mel_rows_split4_plain(padded: torch.Tensor, window: torch.Tensor,
                          fbank_t: torch.Tensor, window_length: int,
                          step: int, number_times: int, power: bool,
                          ops: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`mel_rows_plain` with the rDFT by the split4 scheme (the
    frames split in torch, four exact GEMMs against the presplit operator);
    the filterbank product stays exact."""
    mel_rows_split4_plain.calls += 1
    return _mel_plain(padded, window, fbank_t, window_length, step,
                      number_times, power,
                      split4_spec_ops(ops, window_length, padded.device))


for _fn in (mel_rows_plain, mel_rows_split4_plain):
    _fn.calls = 0


def mel_rows(padded: torch.Tensor, window: torch.Tensor,
             fbank_t: torch.Tensor, window_length: int, step: int,
             number_times: int, power: bool,
             ops: torch.Tensor | None = None) -> torch.Tensor:
    """One-pass mel front end: ``(..., T, n_mels)`` magnitude-mel
    (``power=False``, melspectrogram) or power-mel (``power=True``, the
    MFCC front) rows of a padded signal ``(..., L)``. ``fbank_t``: the
    ``(WL/2, n_mels)`` filterbank transpose. ``ops`` overrides the
    operator (:func:`spec_ops`). Split4 (float32) takes
    :func:`mel_rows_split4`.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises. The kernel stages a
    bin tile's filterbank rows in shared memory 256 mels at a time, so it
    takes any ``n_mels``.
    """
    if split4_applies(padded.dtype):
        return mel_rows_split4(padded, window, fbank_t, window_length, step,
                               number_times, power, ops)
    if not padded.is_cuda:
        return mel_rows_plain(padded, window, fbank_t, window_length, step,
                              number_times, power, ops)
    return _mel_rows_cuda(padded, window, fbank_t, window_length, step,
                          number_times, power, ops)


def mel_rows_split4(padded: torch.Tensor, window: torch.Tensor,
                    fbank_t: torch.Tensor, window_length: int, step: int,
                    number_times: int, power: bool,
                    ops: torch.Tensor | None = None) -> torch.Tensor:
    """The split4 twin of :func:`mel_rows` (``_mel_rows_impl``'s
    ``_kernel_split4``): the rDFT by four bf16 passes with float32 sums.
    ``ops`` is the presplit ``(2, 2, WL, F_pad)`` bf16 stack, or a float32
    operator that is split on the host. A CPU tensor takes the plain
    version; a CUDA tensor launches the tensor-core kernel or raises."""
    if not padded.is_cuda:
        return mel_rows_split4_plain(padded, window, fbank_t, window_length,
                                     step, number_times, power, ops)
    return _mel_rows_cuda(padded, window, fbank_t, window_length, step,
                          number_times, power, ops, split4=True)


def _mel_rows_cuda(padded: torch.Tensor, window: torch.Tensor,
                   fbank_t: torch.Tensor, window_length: int, step: int,
                   number_times: int, power: bool,
                   ops: torch.Tensor | None = None,
                   split4: bool = False) -> torch.Tensor:
    """Check the CUDA input, launch the kernels, exact or (``split4``) the
    twin, count the launch."""
    name = "mel_rows_split4" if split4 else "mel_rows"
    f = window_length // 2
    if fbank_t.ndim != 2 or fbank_t.shape[0] != f or fbank_t.shape[1] < 1:
        raise ValueError(f"{name}: filterbank transpose must be ({f}, "
                         f"n_mels) with n_mels >= 1, got "
                         f"{tuple(fbank_t.shape)}")
    _build.require_f32(fbank_t, name)
    if split4:
        ops = split4_spec_ops(ops, window_length, padded.device)
    sig, win, ops, fp = _device_args(name, padded, window, window_length,
                                     step, number_times, ops, split4)
    t, m, batch = number_times, fbank_t.shape[1], sig.shape[0]
    fbt = fbank_t.to(padded.device).contiguous()
    tiles = fp // TILE_BINS  # each writes a partial; a second pass sums them
    dev = padded.device
    part = (torch.empty((tiles, batch, t, m), dtype=torch.float32, device=dev)
            if tiles > 1 else None)
    out = torch.empty((batch, t, m), dtype=torch.float32, device=dev)
    entry = "zt_" + name
    err = getattr(_build.library(), entry)(
        sig.data_ptr(), win.data_ptr(), ops.data_ptr(), fbt.data_ptr(),
        None if part is None else part.data_ptr(), out.data_ptr(), batch,
        sig.shape[-1], t, window_length, step, f, fp, m, int(power),
        _build.stream_of(padded))
    _build.check(err, entry)
    (mel_rows_split4 if split4 else mel_rows).launches += 1
    return out.reshape(*padded.shape[:-1], t, m)


for _fn in (mel_rows, mel_rows_split4):
    _fn.launches = 0
del _fn
