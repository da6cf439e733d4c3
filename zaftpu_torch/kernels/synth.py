"""Inverse real-DFT GEMM + overlap-add: CUDA kernel (``csrc/synth.cu``) and
its plain version.

Replaces ``zaftpu/pallas/synth.py: _gemm_ola_impl`` as ``istft_ola``
reaches it (two components, cos and -sin). The kernel is FP32-compute-bound;
see the source note in ``csrc/synth.cu`` for how it overlap-adds without
the TPU kernel's sequential carry.
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
REPLACES = "zaftpu/pallas/synth.py:264"  # _gemm_ola_impl

SLICE = 16      # the kernel's contraction slice; each plane is padded to it
TILE_ROWS = 64  # the kernel's output rows (hops) per block


def padded_rows(n: int) -> int:
    return -(-(n // 2 + 1) // SLICE) * SLICE


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
    k = -(-n // step)
    _build.require_grid(batch, -(-(t - 1 + k) // TILE_ROWS), "istft_ola")
    ops = ops.to(h_re.device).contiguous()
    out_len = (t - 1) * step + n
    out = torch.empty((batch, out_len), dtype=torch.float32,
                      device=h_re.device)
    err = _build.library().zt_istft_ola(
        packed.data_ptr(), ops.data_ptr(), out.data_ptr(), batch, t, 2 * kp,
        n, step, _build.stream_of(h_re))
    _build.check(err, "zt_istft_ola")
    istft_ola.launches += 1
    return out.reshape(*lead, out_len)


istft_ola.launches = 0
