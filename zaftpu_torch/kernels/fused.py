"""Framing + window + operator GEMM: CUDA kernels (``csrc/fused.cu``) and
their plain versions.

Replace ``zaftpu/pallas/fused.py: _frames_matmul_impl`` as ``frames_rfft``
(two components, the cos and sin rDFT operators) and ``frames_op`` (one
real operator, the folded MDCT matrix) reach it, and its full-spectrum twin
``_frames_matmul_full_impl`` (``frames_rfft_full``, the conjugate mirror
written by the kernel's store; ``ZAFTPU_FULLSPEC=1``). The kernels are
FP32-compute-bound; see the source notes in ``csrc/fused.cu`` and
``csrc/frames_gemm.cuh``. One launch computes every component from the same
frame tile.
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

CUDA_SOURCE = "zaftpu_torch/csrc/fused.cu"
REPLACES = "zaftpu/pallas/fused.py:279"  # _frames_matmul_impl (frames_rfft)
REPLACES_OP = "zaftpu/pallas/fused.py:590"  # frames_op -> _frames_matmul_impl
REPLACES_FULL = "zaftpu/pallas/fused.py:475"  # _frames_matmul_full_impl

TILE_BINS = 64    # the kernel's bins per block; the operator is padded to it
TILE_FRAMES = 64  # the kernel's frames per block


def padded_cols(cols: int) -> int:
    """``cols`` rounded up to whole 64-column tiles of the kernels."""
    return -(-cols // TILE_BINS) * TILE_BINS


def padded_bins(n: int) -> int:
    return padded_cols(n // 2 + 1)


@lru_cache(maxsize=8)
def _rdft_ops(n: int, rdtype_name: str = "float32") -> np.ndarray:
    """Stacked ``(2, N, F_pad)`` cos/sin rDFT operator, zero columns from
    ``F = N/2+1`` to :func:`padded_bins`: the port of
    ``zaftpu.pallas.fused._rdft_ops_padded``, padded to the kernel's 64-bin
    tiles instead of 128 lanes."""
    cos_m, sin_m = _fft._direct_rdft_mats(n, rdtype_name)
    ops = np.zeros((2, n, padded_bins(n)), rdtype_name)
    ops[0, :, :cos_m.shape[1]] = cos_m
    ops[1, :, :sin_m.shape[1]] = sin_m
    return ops


def rdft_ops(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    return _fft.device_operator(_rdft_ops, (n, _fft._real_name(dtype)),
                                torch.device(device), dtype)


def frames_rfft_plain(padded: torch.Tensor, window: torch.Tensor,
                      window_length: int, step: int, number_times: int,
                      ops: torch.Tensor | None = None) -> torch.Tensor:
    """Half spectrum ``(..., T, WL/2+1)`` of the windowed frames in plain
    PyTorch: framing, window, then the two operator GEMMs."""
    frames_rfft_plain.calls += 1
    return _half_spectrum(padded, window, window_length, step, number_times,
                          ops)


frames_rfft_plain.calls = 0


def _half_spectrum(padded, window, window_length, step, number_times, ops):
    frames = (extract_frames(padded, window_length, step, number_times)
              * window.to(padded.dtype))
    if ops is None:
        ops = rdft_ops(window_length, padded.dtype, padded.device)
    f = window_length // 2 + 1
    return torch.complex(exact_matmul(frames, ops[0, :, :f]),
                         exact_matmul(frames, ops[1, :, :f]))


def frames_rfft(padded: torch.Tensor, window: torch.Tensor,
                window_length: int, step: int, number_times: int,
                ops: torch.Tensor | None = None) -> torch.Tensor:
    """Fused windowed-frames rDFT: ``(..., T, WL/2+1)`` complex half
    spectrum of a padded signal ``(..., L)``, the frames never stored.
    ``ops`` overrides the ``(2, WL, F_pad)`` operator (tests pass
    ``zaftpu``'s through :func:`zaftpu_torch.core.fft.operators_from_numpy`).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not padded.is_cuda:
        return frames_rfft_plain(padded, window, window_length, step,
                                 number_times, ops)
    return _frames_rfft_cuda(padded, window, window_length, step,
                             number_times, ops)


def _frames_rfft_cuda(padded: torch.Tensor, window: torch.Tensor,
                      window_length: int, step: int, number_times: int,
                      ops: torch.Tensor | None = None,
                      full: bool = False) -> torch.Tensor:
    """Check the CUDA input, launch the half- or (``full``) full-spectrum
    kernel, count the launch."""
    name = "frames_rfft_full" if full else "frames_rfft"
    check_frame_args(name, padded, window, window_length, step,
                     number_times)
    wl, t = window_length, number_times
    f = wl // 2 + 1
    length = padded.shape[-1]
    if ops is None:
        ops = rdft_ops(wl, torch.float32, padded.device)
    fp = padded_bins(wl)
    if ops.shape != (2, wl, fp) or ops.dtype != torch.float32:
        raise ValueError(f"{name}: operator must be float32 "
                         f"(2, {wl}, {fp}), got {ops.dtype} "
                         f"{tuple(ops.shape)}")
    lead = padded.shape[:-1]
    sig = padded.reshape(-1, length).contiguous()
    _build.require_grid(sig.shape[0], -(-t // TILE_FRAMES), name)
    win = window.to(device=padded.device, dtype=torch.float32).contiguous()
    ops = ops.to(padded.device).contiguous()
    width = wl if full else f
    out = torch.empty((sig.shape[0], t, width), dtype=torch.complex64,
                      device=padded.device)
    lib = _build.library()
    launch = lib.zt_frames_rfft_full if full else lib.zt_frames_rfft
    err = launch(sig.data_ptr(), win.data_ptr(), ops.data_ptr(),
                 out.data_ptr(), sig.shape[0], length, t, wl, step, f, fp,
                 _build.stream_of(padded))
    _build.check(err, f"zt_{name}")
    (frames_rfft_full if full else frames_rfft).launches += 1
    return out.reshape(*lead, t, width)


frames_rfft.launches = 0


def fullspec_enabled() -> bool:
    """``ZAFTPU_FULLSPEC``: the full-spectrum kernel for ``stft`` only when
    set to ``1`` (``zaftpu``'s lever and default)."""
    return os.environ.get("ZAFTPU_FULLSPEC", "0") == "1"


def frames_rfft_full_plain(padded: torch.Tensor, window: torch.Tensor,
                           window_length: int, step: int, number_times: int,
                           ops: torch.Tensor | None = None) -> torch.Tensor:
    """Full spectrum ``(..., T, WL)`` in plain PyTorch: the plain half
    spectrum, then the conjugate mirror's index gathers."""
    frames_rfft_full_plain.calls += 1
    return _fft.conjugate_mirror(
        _half_spectrum(padded, window, window_length, step, number_times,
                       ops), window_length)


frames_rfft_full_plain.calls = 0


def frames_rfft_full(padded: torch.Tensor, window: torch.Tensor,
                     window_length: int, step: int, number_times: int,
                     ops: torch.Tensor | None = None) -> torch.Tensor:
    """Fused windowed-frames full spectrum: ``(..., T, WL)`` complex, the
    reference's zaf.py:139 convention, with the mirrored bins written by
    the kernel. Bit-equal to :func:`frames_rfft` followed by the conjugate
    mirror, since both store the same sums. ``ops`` as for
    :func:`frames_rfft`.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not padded.is_cuda:
        return frames_rfft_full_plain(padded, window, window_length, step,
                                      number_times, ops)
    return _frames_rfft_cuda(padded, window, window_length, step,
                             number_times, ops, full=True)


frames_rfft_full.launches = 0


def frames_op_plain(padded: torch.Tensor, window: torch.Tensor,
                    ops: torch.Tensor, n_cols: int, window_length: int,
                    step: int, number_times: int) -> torch.Tensor:
    """``windowed_frames @ ops[0, :, :n_cols]``, ``(..., T, n_cols)``, in
    plain PyTorch."""
    frames_op_plain.calls += 1
    frames = (extract_frames(padded, window_length, step, number_times)
              * window.to(padded.dtype))
    return exact_matmul(frames, ops[0, :, :n_cols].to(padded.dtype))


frames_op_plain.calls = 0


def frames_op(padded: torch.Tensor, window: torch.Tensor, ops: torch.Tensor,
              n_cols: int, window_length: int, step: int,
              number_times: int) -> torch.Tensor:
    """Fused ``windowed_frames @ op`` for one real operator: ``(..., T,
    n_cols)`` from a padded signal ``(..., L)``, the frames never stored.
    ``ops`` is ``(1, WL, F_pad)`` with zero columns from ``n_cols`` to
    :func:`padded_cols` (``zaftpu``'s ``frames_op`` takes the host function
    that makes it instead; here the caller uploads it once).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not padded.is_cuda:
        return frames_op_plain(padded, window, ops, n_cols, window_length,
                               step, number_times)
    return _frames_op_cuda(padded, window, ops, n_cols, window_length, step,
                           number_times)


def _frames_op_cuda(padded: torch.Tensor, window: torch.Tensor,
                    ops: torch.Tensor, n_cols: int, window_length: int,
                    step: int, number_times: int) -> torch.Tensor:
    """Check the CUDA input, launch the kernel, count the launch."""
    check_frame_args("frames_op", padded, window, window_length, step,
                     number_times)
    wl, t = window_length, number_times
    fp = padded_cols(n_cols)
    if ops.shape != (1, wl, fp) or ops.dtype != torch.float32:
        raise ValueError(f"frames_op: operator must be float32 "
                         f"(1, {wl}, {fp}), got {ops.dtype} "
                         f"{tuple(ops.shape)}")
    length = padded.shape[-1]
    lead = padded.shape[:-1]
    sig = padded.reshape(-1, length).contiguous()
    _build.require_grid(sig.shape[0], -(-t // TILE_FRAMES), "frames_op")
    win = window.to(device=padded.device, dtype=torch.float32).contiguous()
    ops = ops.to(padded.device).contiguous()
    out = torch.empty((sig.shape[0], t, n_cols), dtype=torch.float32,
                      device=padded.device)
    err = _build.library().zt_frames_op(
        sig.data_ptr(), win.data_ptr(), ops.data_ptr(), out.data_ptr(),
        sig.shape[0], length, t, wl, step, n_cols, fp,
        _build.stream_of(padded))
    _build.check(err, "zt_frames_op")
    frames_op.launches += 1
    return out.reshape(*lead, t, n_cols)


frames_op.launches = 0
