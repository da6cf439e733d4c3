"""Framing + window + real-DFT GEMM: CUDA kernel (``csrc/fused.cu``) and its
plain version.

Replaces ``zaftpu/pallas/fused.py: _frames_matmul_impl`` as ``frames_rfft``
reaches it (two components, cos and sin). The kernel is FP32-compute-bound;
see the source note in ``csrc/fused.cu``. One launch computes both
components from the same frame tile.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core.frame import extract_frames
from zaftpu_torch.core.policy import exact_matmul
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels.framing import check_frame_args

CUDA_SOURCE = "zaftpu_torch/csrc/fused.cu"
REPLACES = "zaftpu/pallas/fused.py:279"  # _frames_matmul_impl

TILE_BINS = 64    # the kernel's bins per block; the operator is padded to it
TILE_FRAMES = 64  # the kernel's frames per block


def padded_bins(n: int) -> int:
    return -(-(n // 2 + 1) // TILE_BINS) * TILE_BINS


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
    frames = (extract_frames(padded, window_length, step, number_times)
              * window.to(padded.dtype))
    if ops is None:
        ops = rdft_ops(window_length, padded.dtype, padded.device)
    f = window_length // 2 + 1
    return torch.complex(exact_matmul(frames, ops[0, :, :f]),
                         exact_matmul(frames, ops[1, :, :f]))


frames_rfft_plain.calls = 0


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
                      ops: torch.Tensor | None = None) -> torch.Tensor:
    """Check the CUDA input, launch the kernel, count the launch."""
    check_frame_args("frames_rfft", padded, window, window_length, step,
                     number_times)
    wl, t = window_length, number_times
    f = wl // 2 + 1
    length = padded.shape[-1]
    if ops is None:
        ops = rdft_ops(wl, torch.float32, padded.device)
    fp = padded_bins(wl)
    if ops.shape != (2, wl, fp) or ops.dtype != torch.float32:
        raise ValueError(f"frames_rfft: operator must be float32 "
                         f"(2, {wl}, {fp}), got {ops.dtype} "
                         f"{tuple(ops.shape)}")
    lead = padded.shape[:-1]
    sig = padded.reshape(-1, length).contiguous()
    _build.require_grid(sig.shape[0], -(-t // TILE_FRAMES), "frames_rfft")
    win = window.to(device=padded.device, dtype=torch.float32).contiguous()
    ops = ops.to(padded.device).contiguous()
    out = torch.empty((sig.shape[0], t, f), dtype=torch.complex64,
                      device=padded.device)
    err = _build.library().zt_frames_rfft(
        sig.data_ptr(), win.data_ptr(), ops.data_ptr(), out.data_ptr(),
        sig.shape[0], length, t, wl, step, f, fp, _build.stream_of(padded))
    _build.check(err, "zt_frames_rfft")
    frames_rfft.launches += 1
    return out.reshape(*lead, t, f)


frames_rfft.launches = 0
