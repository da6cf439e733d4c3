"""Inverse GEMM + overlap-add: CUDA kernel (``csrc/synth.cu``) and its plain
versions.

Replaces ``zaftpu/pallas/synth.py: _gemm_ola_impl`` as ``istft_ola`` (two
components, cos and -sin, over the Hermitian-folded planes) and
``imdct_ola`` (one component, the window-folded inverse MDCT matrix) reach
it. Both launch the same kernel, whose contraction width and hop are
arguments. It is FP32-compute-bound; see the source note in
``csrc/synth.cu`` for how it overlap-adds without the TPU kernel's
sequential carry.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core import frame as _frame
from zaftpu_torch.core.policy import exact_matmul
from zaftpu_torch.kernels import _build

CUDA_SOURCE = "zaftpu_torch/csrc/synth.cu"
REPLACES = "zaftpu/pallas/synth.py:264"  # _gemm_ola_impl (istft_ola)
REPLACES_IMDCT = "zaftpu/pallas/synth.py:408"  # imdct_ola -> _gemm_ola_impl

SLICE = 16      # the kernel's contraction slice; each plane is padded to it
TILE_ROWS = 64  # the kernel's output rows (hops) per block


def padded_slices(rows: int) -> int:
    """``rows`` rounded up to whole 16-row contraction slices."""
    return -(-rows // SLICE) * SLICE


def padded_rows(n: int) -> int:
    return padded_slices(n // 2 + 1)


@lru_cache(maxsize=8)
def _istft_ops(n: int, scale: float, rdtype_name: str = "float32"):
    """Stacked ``(2, KP, N)`` inverse-rDFT operator (cos, -sin) with the
    pair weights, 1/N and ``scale`` (the COLA 1/gain) folded in, zero rows
    from ``F = N/2+1`` to ``KP`` (:func:`padded_rows`): the port of
    ``zaftpu.pallas.synth._istft_ops_padded``, padded to the kernel's
    16-row slices instead of 128 lanes."""
    cos_m, sin_m = _fft._direct_ridft_half_mats(n, rdtype_name, float(scale))
    ops = np.zeros((2, padded_rows(n), n), rdtype_name)
    ops[0, :cos_m.shape[0]] = cos_m
    ops[1, :sin_m.shape[0]] = -sin_m
    return ops


def istft_ops(n: int, scale: float, dtype: torch.dtype,
              device) -> torch.Tensor:
    return _fft.device_operator(_istft_ops,
                                (n, float(scale), _fft._real_name(dtype)),
                                torch.device(device), dtype)


def istft_ola_plain(h_re: torch.Tensor, h_im: torch.Tensor, n: int,
                    step: int, scale: float,
                    ops: torch.Tensor | None = None) -> torch.Tensor:
    """``overlap_add(h_re @ op[0] + h_im @ op[1], step)`` in plain
    PyTorch."""
    istft_ola_plain.calls += 1
    if ops is None:
        ops = istft_ops(n, scale, h_re.dtype, h_re.device)
    f = n // 2 + 1
    frames = exact_matmul(h_re, ops[0, :f]) + exact_matmul(h_im, ops[1, :f])
    return _frame.overlap_add(frames, step)


istft_ola_plain.calls = 0


def istft_ola(h_re: torch.Tensor, h_im: torch.Tensor, n: int, step: int,
              scale: float, ops: torch.Tensor | None = None) -> torch.Tensor:
    """Fused ISTFT synthesis from Hermitian-folded planes ``(..., T, N/2+1)``:
    inverse-rDFT GEMM and overlap-add in one pass, returning the
    ``(..., T*step + N - step)`` signal before the trim. ``scale`` (the COLA
    1/gain) is folded into the operator; ``ops`` overrides it. The kernel
    reads the two planes packed into zero-padded ``(T, 2, KP)`` rows.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not h_re.is_cuda:
        return istft_ola_plain(h_re, h_im, n, step, scale, ops)
    return _istft_ola_cuda(h_re, h_im, n, step, scale, ops)


def _istft_ola_cuda(h_re: torch.Tensor, h_im: torch.Tensor, n: int,
                    step: int, scale: float,
                    ops: torch.Tensor | None = None) -> torch.Tensor:
    """Check the CUDA input, launch the kernel, count the launch."""
    _build.require_f32(h_re, "istft_ola")
    _build.require_f32(h_im, "istft_ola")
    f = n // 2 + 1
    *lead, t, width = h_re.shape
    if h_im.shape != h_re.shape or width != f:
        raise ValueError(f"istft_ola: planes must both be (..., T, {f}), got "
                         f"{tuple(h_re.shape)} and {tuple(h_im.shape)}")
    if not 1 <= step <= n:
        raise ValueError(f"istft_ola: need step in [1, {n}], got {step}")
    kp = padded_rows(n)
    if ops is None:
        ops = istft_ops(n, scale, torch.float32, h_re.device)
    if ops.shape != (2, kp, n) or ops.dtype != torch.float32:
        raise ValueError(f"istft_ola: operator must be float32 "
                         f"(2, {kp}, {n}), got {ops.dtype} "
                         f"{tuple(ops.shape)}")
    batch = math.prod(lead)
    packed = torch.zeros((batch, t, 2, kp), dtype=torch.float32,
                         device=h_re.device)
    packed[:, :, 0, :f] = h_re.reshape(batch, t, f)
    packed[:, :, 1, :f] = h_im.reshape(batch, t, f)
    out = _gemm_ola(packed.view(batch, t, 2 * kp), ops.reshape(2 * kp, n), n,
                    step, "istft_ola")
    istft_ola.launches += 1
    return out.reshape(*lead, out.shape[-1])


def _gemm_ola(h: torch.Tensor, ops: torch.Tensor, n: int, step: int,
              name: str) -> torch.Tensor:
    """Launch the kernel on ``h`` ``(batch, T, Q)`` and ``ops`` ``(Q, N)``,
    both float32 with Q a multiple of 16; returns ``(batch, (T-1)*step +
    N)``."""
    batch, t, q = h.shape
    k = -(-n // step)
    _build.require_grid(batch, -(-(t - 1 + k) // TILE_ROWS), name)
    ops = ops.to(h.device).contiguous()
    out_len = (t - 1) * step + n
    out = torch.empty((batch, out_len), dtype=torch.float32, device=h.device)
    err = _build.library().zt_gemm_ola(
        h.data_ptr(), ops.data_ptr(), out.data_ptr(), batch, t, q, n, step,
        _build.stream_of(h))
    _build.check(err, f"zt_gemm_ola ({name})")
    return out


istft_ola.launches = 0


@lru_cache(maxsize=8)
def _imdct_ops(f: int, window_bytes: bytes, rdtype_name: str = "float32"):
    """The window-folded ``(F, 2F)`` inverse-MDCT matrix
    (:func:`zaftpu_torch.transforms.mdct._direct_inverse_windowed_matrix`)
    as ``(Q, 2F)``, zero rows from F to Q (:func:`padded_slices`): the port
    of ``zaftpu.pallas.synth._imdct_ops_padded``, padded to the kernel's
    16-row slices. ``window_bytes``: the float64 window's bytes."""
    from zaftpu_torch.transforms.mdct import _direct_inverse_windowed_matrix

    m = _direct_inverse_windowed_matrix(f, window_bytes).astype(rdtype_name)
    ops = np.zeros((padded_slices(f), 2 * f), rdtype_name)
    ops[:f] = m
    return ops


def imdct_ops(f: int, window_bytes: bytes, dtype: torch.dtype,
              device) -> torch.Tensor:
    return _fft.device_operator(_imdct_ops,
                                (f, window_bytes, _fft._real_name(dtype)),
                                torch.device(device), dtype)


def imdct_ola_plain(coeffs: torch.Tensor, f: int, window_bytes: bytes,
                    ops: torch.Tensor | None = None) -> torch.Tensor:
    """``overlap_add(coeffs @ op[:F], F)`` in plain PyTorch."""
    imdct_ola_plain.calls += 1
    if ops is None:
        ops = imdct_ops(f, window_bytes, coeffs.dtype, coeffs.device)
    return _frame.overlap_add(exact_matmul(coeffs, ops[:f]), f)


imdct_ola_plain.calls = 0


def imdct_ola(coeffs: torch.Tensor, f: int, window_bytes: bytes,
              ops: torch.Tensor | None = None) -> torch.Tensor:
    """Fused IMDCT synthesis from frames-major coefficients ``(..., T, F)``:
    the window-folded inverse GEMM and the TDAC overlap-add in one pass,
    returning the ``(..., T*F + F)`` signal before the reference's trim.
    ``window_bytes`` (the float64 window's bytes) keys the operator;
    ``ops`` overrides it.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not coeffs.is_cuda:
        return imdct_ola_plain(coeffs, f, window_bytes, ops)
    return _imdct_ola_cuda(coeffs, f, window_bytes, ops)


def _imdct_ola_cuda(coeffs: torch.Tensor, f: int, window_bytes: bytes,
                    ops: torch.Tensor | None = None) -> torch.Tensor:
    """Check the CUDA input, launch the kernel, count the launch."""
    _build.require_f32(coeffs, "imdct_ola")
    *lead, t, width = coeffs.shape
    if width != f:
        raise ValueError(f"imdct_ola: coefficients must be (..., T, {f}), "
                         f"got {tuple(coeffs.shape)}")
    q = padded_slices(f)
    if ops is None:
        ops = imdct_ops(f, window_bytes, torch.float32, coeffs.device)
    if ops.shape != (q, 2 * f) or ops.dtype != torch.float32:
        raise ValueError(f"imdct_ola: operator must be float32 "
                         f"({q}, {2 * f}), got {ops.dtype} "
                         f"{tuple(ops.shape)}")
    batch = math.prod(lead)
    h = coeffs.reshape(batch, t, f)
    if q != f:
        h = torch.nn.functional.pad(h, (0, q - f))
    elif not h.is_contiguous() or h.data_ptr() % 16:
        h = h.clone(memory_format=torch.contiguous_format)
    out = _gemm_ola(h, ops, 2 * f, f, "imdct_ola")
    imdct_ola.launches += 1
    return out.reshape(*lead, out.shape[-1])


imdct_ola.launches = 0
