"""Inverse GEMM + overlap-add: CUDA kernel (``csrc/synth.cu``) and its plain
versions.

Replaces ``zaftpu/pallas/synth.py: _gemm_ola_impl`` as ``istft_ola`` (two
components, cos and -sin, over the Hermitian-folded planes) and
``imdct_ola`` (one component, the window-folded inverse MDCT matrix) reach
it. Both launch the same kernel, whose contraction width and hop are
arguments. It is FP32-compute-bound; see the source note in
``csrc/synth.cu`` for how it overlap-adds without the TPU kernel's
sequential carry.

Under ``ZAFTPU_PRECISION=split4`` (float32 only; ``high`` and ``default``
on CUDA) both launch the split4 twin instead, the port of
``_kernel_split4``: the spectrum rows split into bf16 hi/lo in the kernel,
the operator presplit on the host, the dial's bf16 passes (4, 3 or 1) on
the tensor cores with float32 sums, the same overlap-add.

On every dial ``istft_ola`` first follows the inverse kernel's shape rule
(:func:`zaftpu_torch.kernels.irfft.applies`): at every window length from
16 to 4096, with no explicit ``ops`` and ``ZAFTPU_FFT`` not ``matmul``, it
takes the inverse real-FFT kernel of :mod:`zaftpu_torch.kernels.irfft`
(``csrc/irfft.cu``; an odd window a complex FFT a frame, a prime factor
above 127 by Bluestein), as ``zaftpu`` runs its FFT off the TPU; a window
below 16, an explicit operator and ``ZAFTPU_FFT=matmul`` keep the GEMM
kernel or its twin. ``imdct_ola`` follows the MDCT's rule
(:func:`zaftpu_torch.kernels.mdct.applies`) the same way: the fast IMDCT +
overlap-add kernel of :mod:`zaftpu_torch.kernels.mdct` (``csrc/mdct.cu``)
at a window length that is a multiple of 4 up to 4096 whose quarter has no
prime factor above 127.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core import frame as _frame
from zaftpu_torch.core.policy import (exact_matmul, gemm_passes,
                                      split_matmul_presplit)
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import irfft as _irfft
from zaftpu_torch.kernels import mdct as _mdct

CUDA_SOURCE = "zaftpu_torch/csrc/synth.cu"
REPLACES = "zaftpu/pallas/synth.py:264"  # _gemm_ola_impl (istft_ola)
REPLACES_IMDCT = "zaftpu/pallas/synth.py:408"  # imdct_ola -> _gemm_ola_impl
REPLACES_SPLIT4 = "zaftpu/pallas/synth.py:231"  # _kernel_split4 (B4, B7)

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


def _presplit_ops(ops: torch.Tensor | None, builder, args: tuple,
                  device) -> torch.Tensor:
    """A split4 twin's operator as the kernel takes it: the ``(2, Q, N)``
    bf16 hi/lo stack of ``ops`` or ``builder(*args)``
    (:func:`zaftpu_torch.core.fft.presplit_operator`), the components'
    rows side by side along Q."""
    ops = _fft.presplit_operator(ops, builder, args, device)
    return ops.reshape(2, -1, ops.shape[-1])


def istft_ops_split4(n: int, scale: float, device) -> torch.Tensor:
    """:func:`istft_ops` presplit: ``(2, 2*KP, N)`` bf16, hi then lo."""
    return _presplit_ops(None, _istft_ops, (n, float(scale), "float32"),
                         device)


def _packed_planes(h_re: torch.Tensor, h_im: torch.Tensor,
                   n: int) -> torch.Tensor:
    """The folded planes ``(..., T, N/2+1)`` packed into zero-padded
    ``(batch, T, 2*KP)`` rows, the synthesis kernels' contraction."""
    f, kp = n // 2 + 1, padded_rows(n)
    *lead, t, _ = h_re.shape
    batch = math.prod(lead)
    packed = torch.zeros((batch, t, 2, kp), dtype=h_re.dtype,
                         device=h_re.device)
    packed[:, :, 0, :f] = h_re.reshape(batch, t, f)
    packed[:, :, 1, :f] = h_im.reshape(batch, t, f)
    return packed.view(batch, t, 2 * kp)


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


def istft_ola_split4_plain(h_re: torch.Tensor, h_im: torch.Tensor, n: int,
                           step: int, scale: float,
                           ops: torch.Tensor | None = None,
                           passes: int = 4) -> torch.Tensor:
    """The split4 synthesis in plain PyTorch: the packed planes
    ``(T, 2*KP)`` times the presplit operator by the bf16 scheme at
    ``passes``, then the plain overlap-add. ``ops`` as for
    :func:`istft_ola_split4`."""
    istft_ola_split4_plain.calls += 1
    ops = _presplit_ops(ops, _istft_ops, (n, float(scale), "float32"),
                        h_re.device)
    frames = split_matmul_presplit(_packed_planes(h_re, h_im, n), ops[0],
                                   ops[1], passes)
    out = _frame.overlap_add(frames, step)
    return out.reshape(*h_re.shape[:-2], out.shape[-1])


istft_ola_plain.calls = 0
istft_ola_split4_plain.calls = 0


def istft_ola(h_re: torch.Tensor, h_im: torch.Tensor, n: int, step: int,
              scale: float, ops: torch.Tensor | None = None) -> torch.Tensor:
    """Fused ISTFT synthesis from Hermitian-folded planes ``(..., T, N/2+1)``:
    inverse-rDFT GEMM and overlap-add in one pass, returning the
    ``(..., T*step + N - step)`` signal before the trim. ``scale`` (the COLA
    1/gain) is folded into the operator; ``ops`` overrides it, and names
    the GEMM at any window. The kernel reads the two planes packed into
    zero-padded ``(T, 2, KP)`` rows.

    The shape rule (:func:`zaftpu_torch.kernels.irfft.applies`) takes
    :func:`zaftpu_torch.kernels.irfft.istft_ola_fft` on every dial;
    elsewhere a lowered dial (float32, ``policy.gemm_passes``) takes
    :func:`istft_ola_split4` at its pass count. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (leading axes
    flattened into its batch) or raises.
    """
    if _irfft.applies(n, ops):
        return _irfft.istft_ola_fft(h_re, h_im, n, step, scale)
    p = gemm_passes(h_re.dtype, h_re.device)
    if p is not None:
        return istft_ola_split4(h_re, h_im, n, step, scale, ops, passes=p)
    if not h_re.is_cuda:
        return istft_ola_plain(h_re, h_im, n, step, scale, ops)
    return _istft_ola_cuda(h_re, h_im, n, step, scale, ops)


def istft_ola_split4(h_re: torch.Tensor, h_im: torch.Tensor, n: int,
                     step: int, scale: float,
                     ops: torch.Tensor | None = None,
                     passes: int = 4) -> torch.Tensor:
    """The split4 twin of :func:`istft_ola` (B4's ``_kernel_split4``) at
    ``passes`` (4, 3 or 1) bf16 passes. ``ops`` is the presplit
    ``(2, 2*KP, N)`` bf16 stack (:func:`istft_ops_split4`), or a float32
    ``(2, KP, N)`` operator that is split on the host. A CPU tensor takes
    the plain version; a CUDA tensor launches the tensor-core kernel or
    raises."""
    if not h_re.is_cuda:
        return istft_ola_split4_plain(h_re, h_im, n, step, scale, ops,
                                      passes)
    return _istft_ola_cuda(h_re, h_im, n, step, scale, ops, split4=True,
                           passes=passes)


def _istft_ola_cuda(h_re: torch.Tensor, h_im: torch.Tensor, n: int,
                    step: int, scale: float,
                    ops: torch.Tensor | None = None,
                    split4: bool = False, passes: int = 4) -> torch.Tensor:
    """Check the CUDA input, launch the kernel or (``split4``) its twin at
    ``passes``, count the launch."""
    name = "istft_ola_split4" if split4 else "istft_ola"
    _build.require_f32(h_re, name)
    _build.require_f32(h_im, name)
    f = n // 2 + 1
    *lead, t, width = h_re.shape
    if h_im.shape != h_re.shape or width != f:
        raise ValueError(f"{name}: planes must both be (..., T, {f}), got "
                         f"{tuple(h_re.shape)} and {tuple(h_im.shape)}")
    if not 1 <= step <= n:
        raise ValueError(f"{name}: need step in [1, {n}], got {step}")
    kp = padded_rows(n)
    if split4:
        ops = _presplit_ops(ops, _istft_ops, (n, float(scale), "float32"),
                            h_re.device)
    else:
        if ops is None:
            ops = istft_ops(n, scale, torch.float32, h_re.device)
        if ops.shape == (2, kp, n):  # both components along one contraction
            ops = ops.reshape(2 * kp, n)
    out = _gemm_ola(_packed_planes(h_re, h_im, n), ops, n, step, name,
                    split4, passes)
    (istft_ola_split4 if split4 else istft_ola).launches += 1
    return out.reshape(*lead, out.shape[-1])


def _gemm_ola(h: torch.Tensor, ops: torch.Tensor, n: int, step: int,
              name: str, split4: bool = False,
              passes: int = 4) -> torch.Tensor:
    """Check ``ops`` and launch the kernel on ``h`` ``(batch, T, Q)``,
    float32 with Q a multiple of 16, and ``ops``: float32 ``(Q, N)``, or
    for the split4 twin (at ``passes``) the presplit ``(2, Q, N)`` bf16
    stack; returns ``(batch, (T-1)*step + N)``."""
    batch, t, q = h.shape
    shape = (2, q, n) if split4 else (q, n)
    dtype = torch.bfloat16 if split4 else torch.float32
    if tuple(ops.shape) != shape or ops.dtype != dtype:
        raise ValueError(f"{name}: operator must be {dtype} {shape}, got "
                         f"{ops.dtype} {tuple(ops.shape)}")
    k = -(-n // step)
    _build.require_grid(batch, -(-(t - 1 + k) // TILE_ROWS), name)
    ops = ops.to(h.device).contiguous()
    out_len = (t - 1) * step + n
    out = torch.empty((batch, out_len), dtype=torch.float32, device=h.device)
    entry = "zt_gemm_ola_split4" if split4 else "zt_gemm_ola"
    args = (h.data_ptr(), ops.data_ptr(), out.data_ptr(), batch, t, q, n,
            step)
    if split4:
        args += (_build.check_passes(passes, name),)
    err = getattr(_build.library(), entry)(*args, _build.stream_of(h))
    _build.check(err, f"{entry} ({name})")
    return out


istft_ola.launches = 0
istft_ola_split4.launches = 0


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


def imdct_ops_split4(f: int, window_bytes: bytes, device) -> torch.Tensor:
    """:func:`imdct_ops` presplit: ``(2, Q, 2F)`` bf16, hi then lo."""
    return _presplit_ops(None, _imdct_ops, (f, window_bytes, "float32"),
                         device)


def imdct_ola_plain(coeffs: torch.Tensor, f: int, window_bytes: bytes,
                    ops: torch.Tensor | None = None) -> torch.Tensor:
    """``overlap_add(coeffs @ op[:F], F)`` in plain PyTorch."""
    imdct_ola_plain.calls += 1
    if ops is None:
        ops = imdct_ops(f, window_bytes, coeffs.dtype, coeffs.device)
    return _frame.overlap_add(exact_matmul(coeffs, ops[:f]), f)


def imdct_ola_split4_plain(coeffs: torch.Tensor, f: int, window_bytes: bytes,
                           ops: torch.Tensor | None = None,
                           passes: int = 4) -> torch.Tensor:
    """The split4 IMDCT synthesis in plain PyTorch: the coefficients times
    the presplit operator by the bf16 scheme at ``passes``, then the plain
    overlap-add. ``ops`` as for :func:`imdct_ola_split4`."""
    imdct_ola_split4_plain.calls += 1
    ops = _presplit_ops(ops, _imdct_ops, (f, window_bytes, "float32"),
                        coeffs.device)
    return _frame.overlap_add(
        split_matmul_presplit(coeffs, ops[0, :f], ops[1, :f], passes), f)


imdct_ola_plain.calls = 0
imdct_ola_split4_plain.calls = 0


def imdct_ola(coeffs: torch.Tensor, f: int, window_bytes: bytes,
              ops: torch.Tensor | None = None) -> torch.Tensor:
    """Fused IMDCT synthesis from frames-major coefficients ``(..., T, F)``:
    the window-folded inverse GEMM and the TDAC overlap-add in one pass,
    returning the ``(..., T*F + F)`` signal before the reference's trim.
    ``window_bytes`` (the float64 window's bytes) keys the operator;
    ``ops`` overrides it.

    The MDCT's shape rule (:func:`zaftpu_torch.kernels.mdct.applies`)
    takes :func:`zaftpu_torch.kernels.mdct.imdct_ola_fft` on every dial;
    elsewhere a lowered dial (float32, ``policy.gemm_passes``) takes
    :func:`imdct_ola_split4` at its pass count. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (leading axes
    flattened into its batch) or raises.
    """
    if _mdct.applies(2 * f, ops):
        return _mdct.imdct_ola_fft(coeffs, f, window_bytes)
    p = gemm_passes(coeffs.dtype, coeffs.device)
    if p is not None:
        return imdct_ola_split4(coeffs, f, window_bytes, ops, passes=p)
    if not coeffs.is_cuda:
        return imdct_ola_plain(coeffs, f, window_bytes, ops)
    return _imdct_ola_cuda(coeffs, f, window_bytes, ops)


def imdct_ola_split4(coeffs: torch.Tensor, f: int, window_bytes: bytes,
                     ops: torch.Tensor | None = None,
                     passes: int = 4) -> torch.Tensor:
    """The split4 twin of :func:`imdct_ola` (B7's ``_kernel_split4``) at
    ``passes`` (4, 3 or 1). ``ops`` is the presplit ``(2, Q, 2F)`` bf16
    stack (:func:`imdct_ops_split4`), or a float32 ``(Q, 2F)`` operator
    that is split on the host. A CPU tensor takes the plain version; a CUDA
    tensor launches the tensor-core kernel or raises."""
    if not coeffs.is_cuda:
        return imdct_ola_split4_plain(coeffs, f, window_bytes, ops, passes)
    return _imdct_ola_cuda(coeffs, f, window_bytes, ops, split4=True,
                           passes=passes)


def _imdct_ola_cuda(coeffs: torch.Tensor, f: int, window_bytes: bytes,
                    ops: torch.Tensor | None = None,
                    split4: bool = False, passes: int = 4) -> torch.Tensor:
    """Check the CUDA input, launch the kernel or (``split4``) its twin at
    ``passes``, count the launch."""
    name = "imdct_ola_split4" if split4 else "imdct_ola"
    _build.require_f32(coeffs, name)
    *lead, t, width = coeffs.shape
    if width != f:
        raise ValueError(f"{name}: coefficients must be (..., T, {f}), "
                         f"got {tuple(coeffs.shape)}")
    q = padded_slices(f)
    if split4:
        ops = _presplit_ops(ops, _imdct_ops, (f, window_bytes, "float32"),
                            coeffs.device)
    elif ops is None:
        ops = imdct_ops(f, window_bytes, torch.float32, coeffs.device)
    batch = math.prod(lead)
    h = coeffs.reshape(batch, t, f)
    if q != f:
        h = torch.nn.functional.pad(h, (0, q - f))
    elif not h.is_contiguous() or h.data_ptr() % 16:
        h = h.clone(memory_format=torch.contiguous_format)
    out = _gemm_ola(h, ops, 2 * f, f, name, split4, passes)
    (imdct_ola_split4 if split4 else imdct_ola).launches += 1
    return out.reshape(*lead, out.shape[-1])


imdct_ola.launches = 0
imdct_ola_split4.launches = 0
