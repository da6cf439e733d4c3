"""The magnitude CQT: CUDA kernel (``csrc/cqtslab.cu``) and its plain
version.

``cqt_magnitudes`` replaces ``zaftpu/pallas/cqtslab.py:
magnitudes_in_trace`` (its exact ``_kernel``): ``|frames @ (M_re + i
M_im)|`` for every frame of a padded signal, where ``M`` is the ``(L, F)``
time-domain CQT operator (the FFT of the kernel rows, transposed; see
:mod:`zaftpu_torch.transforms.cqt`). Both versions take it as one
``(2, L, F_pad)`` float32 stack, zero columns from F to whole 64-column
tiles (:func:`time_ops`).

The plain version is ``zaftpu``'s XLA slab loop (``cqt._blocked_matmul_impl``):
the operator is cut into hop-wide slabs ``M[k*step:(k+1)*step]``, and slab
k multiplies the contiguous ``(T, step)`` view of the padded signal that
starts at sample ``k*step``, for k ascending. The kernel reads the frames
from the signal directly and sums the contraction in chunks of 2,048
samples (``csrc/cqtslab.cu``), so the two agree to float32 rounding, not
bit for bit.

``cqt_magnitudes_split4`` replaces the bf16 split4 twin (``_kernel_split4``),
the CQT's default on ``zaftpu``'s accelerator: each slab product by the
4-pass scheme, the signal split into bf16 hi and lo as it is read, the
operator presplit on the host (:func:`time_ops_split4`). Its plain version
is the slab loop with each slab product a
:func:`zaftpu_torch.core.policy.split_matmul_presplit`; the kernel runs
the tensor cores over the same chunks as the exact one. It takes a pass
count: 4 (split4), 3 (``ZAFTPU_PRECISION=high``) or 1
(``ZAFTPU_PRECISION=default``, and ``compute_dtype("bfloat16")``, which
multiplies the signal rounded to bf16 by the operator's hi half).

Both run where the spectral kernel (:mod:`zaftpu_torch.kernels.cqtfft`)
does not: an FFT length above 32,768 or not a power of two, and under
``ZAFTPU_FFT=matmul``.
"""

from __future__ import annotations

import numpy as np
import torch

from zaftpu_torch.core.fft import presplit_operator
from zaftpu_torch.core.policy import (exact_matmul, mxu_matmul,
                                      presplit_host, split_matmul_presplit)
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels.fused import TILE_FRAMES, padded_cols

CUDA_SOURCE = "zaftpu_torch/csrc/cqtslab.cu"
REPLACES = "zaftpu/pallas/cqtslab.py:290"  # magnitudes_in_trace
REPLACES_SPLIT4 = "zaftpu/pallas/cqtslab.py:203"  # _kernel_split4


def time_ops(time_kernel: np.ndarray, dtype=np.float32) -> np.ndarray:
    """The ``(2, L, F_pad)`` stack of ``time_kernel.T``'s real and imaginary
    parts (``time_kernel``: ``(F, L)`` complex), cast to ``dtype`` as
    ``zaftpu``'s ``_device_time_kernel`` casts them, zero columns from F to
    :func:`zaftpu_torch.kernels.fused.padded_cols`."""
    f, length = time_kernel.shape
    ops = np.zeros((2, length, padded_cols(f)), dtype)
    ops[0, :, :f] = np.ascontiguousarray(time_kernel.real.T).astype(dtype)
    ops[1, :, :f] = np.ascontiguousarray(time_kernel.imag.T).astype(dtype)
    return ops


def time_ops_split4(time_kernel: np.ndarray) -> np.ndarray:
    """The ``(2, 2, L, F_pad)`` presplit of :func:`time_ops`: bf16 hi then
    lo (:func:`zaftpu_torch.core.policy.presplit_host`), each the real then
    the imaginary plane, as float32 arrays of bf16 values. The values are
    ``zaftpu``'s ``_slab_ops_host_split`` with its slabs put back into rows
    and its lane-padding rows dropped."""
    return presplit_host(time_ops(time_kernel))


def slab_needed(number_times: int, step: int, fft_length: int) -> int:
    """Samples the slab loop reads: every slab view spans ``T * step``
    samples, so coverage rounds ``fft_length`` up to whole hops
    (``zaftpu``'s ``cqt._blocked_needed``)."""
    return (number_times - 1) * step + -(-fft_length // step) * step


def _slab_loop(padded, step, length, number_times, product):
    """Re and im ``(..., T, F)`` of the slab loop: ``product(slab, lo,
    width, c)`` is slab k's product with operator component ``c`` over rows
    ``lo..lo+width``, added for k ascending. A signal shorter than the
    slabs' reach is zero-extended."""
    t = number_times
    need = slab_needed(t, step, length)
    if padded.shape[-1] < need:
        padded = torch.nn.functional.pad(padded,
                                         (0, need - padded.shape[-1]))
    lead = padded.shape[:-1]
    re = im = None
    for lo in range(0, length, step):
        width = min(step, length - lo)
        slab = padded[..., lo:lo + t * step].reshape(*lead, t, step)
        slab = slab[..., :width]
        pr = product(slab, lo, width, 0)
        pi = product(slab, lo, width, 1)
        re = pr if re is None else re + pr
        im = pi if im is None else im + pi
    return re, im


def cqt_magnitudes_plain(padded: torch.Tensor, ops: torch.Tensor, step: int,
                         fft_length: int, number_times: int,
                         f_channels: int) -> torch.Tensor:
    """``(..., T, F)`` CQT magnitudes in plain PyTorch: the slab loop, each
    slab product an :func:`exact_matmul`, slabs added in ascending order,
    then ``sqrt(re² + im²)``. A signal shorter than the slabs' reach is
    zero-extended."""
    cqt_magnitudes_plain.calls += 1
    f = f_channels
    ops = ops.to(padded.dtype)
    re, im = _slab_loop(
        padded, step, fft_length, number_times,
        lambda slab, lo, width, c: exact_matmul(slab,
                                                ops[c, lo:lo + width, :f]))
    return torch.sqrt(re * re + im * im)


def cqt_magnitudes_split4_plain(padded: torch.Tensor, ops: torch.Tensor,
                                step: int, fft_length: int,
                                number_times: int, f_channels: int,
                                passes: int = 4) -> torch.Tensor:
    """:func:`cqt_magnitudes_plain` with each slab product by the bf16
    scheme at ``passes`` (``zaftpu``'s ``_kernel_split4`` at 4; at 1 the
    bf16 compute dtype's one pass, ``policy.mxu_matmul``): the slab split
    into bf16 hi and lo, that many exact GEMMs against the presplit
    operator, smallest first. ``ops``: the presplit ``(2, 2, L, F_pad)``
    bf16 stack, or the float32 ``(2, L, F_pad)`` one, split on the host."""
    cqt_magnitudes_split4_plain.calls += 1
    f = f_channels
    ops = presplit_operator(ops)

    def product(slab, lo, width, c):
        hi = ops[0, c, lo:lo + width, :f]
        if passes == 1:
            return mxu_matmul(slab, hi)
        return split_matmul_presplit(slab, hi, ops[1, c, lo:lo + width, :f],
                                     passes)

    re, im = _slab_loop(padded, step, fft_length, number_times, product)
    return torch.sqrt(re * re + im * im)


for _fn in (cqt_magnitudes_plain, cqt_magnitudes_split4_plain):
    _fn.calls = 0


def cqt_magnitudes(padded: torch.Tensor, ops: torch.Tensor, step: int,
                   fft_length: int, number_times: int,
                   f_channels: int) -> torch.Tensor:
    """Magnitude CQT ``(..., T, F)`` of a padded signal ``(..., L_pad)``:
    frame ``t`` is samples ``[t*step, t*step + fft_length)``. ``ops`` is the
    ``(2, fft_length, F_pad)`` stack of :func:`time_ops`.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not padded.is_cuda:
        return cqt_magnitudes_plain(padded, ops, step, fft_length,
                                    number_times, f_channels)
    return _cqt_magnitudes_cuda(padded, ops, step, fft_length, number_times,
                                f_channels)


def cqt_magnitudes_split4(padded: torch.Tensor, ops: torch.Tensor, step: int,
                          fft_length: int, number_times: int,
                          f_channels: int, passes: int = 4) -> torch.Tensor:
    """The split4 twin of :func:`cqt_magnitudes`: the same magnitudes with
    each product by ``passes`` (4, 3 or 1) bf16 passes with float32 sums.
    ``ops`` is the presplit ``(2, 2, fft_length, F_pad)`` bf16 stack of
    :func:`time_ops_split4`, or the float32 one, split on the host.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    tensor-core kernel (leading axes flattened into its batch) or raises.
    """
    if not padded.is_cuda:
        return cqt_magnitudes_split4_plain(padded, ops, step, fft_length,
                                           number_times, f_channels, passes)
    return _cqt_magnitudes_cuda(padded, ops, step, fft_length, number_times,
                                f_channels, split4=True, passes=passes)


def _cqt_magnitudes_cuda(padded: torch.Tensor, ops: torch.Tensor, step: int,
                         fft_length: int, number_times: int,
                         f_channels: int, split4: bool = False,
                         passes: int = 4) -> torch.Tensor:
    """Check the CUDA input, launch the kernels, exact or (``split4``) the
    twin at ``passes``, count the launch."""
    name = "cqt_magnitudes_split4" if split4 else "cqt_magnitudes"
    _build.require_f32(padded, name)
    t, f, length = number_times, f_channels, fft_length
    fp = padded_cols(f)
    if step < 1 or t < 1 or f < 1:
        raise ValueError(f"{name}: need step, T and F >= 1, got "
                         f"{step}, {t} and {f}")
    if split4:
        ops = presplit_operator(ops)
    shape = (2, 2, length, fp) if split4 else (2, length, fp)
    dtype = torch.bfloat16 if split4 else torch.float32
    if tuple(ops.shape) != shape or ops.dtype != dtype:
        raise ValueError(f"{name}: operator must be {dtype} {shape}, got "
                         f"{ops.dtype} {tuple(ops.shape)}")
    if padded.shape[-1] < (t - 1) * step + length:
        raise ValueError(f"{name}: {padded.shape[-1]} samples hold "
                         f"fewer than {t} frames of {length} at hop {step}")
    sig = padded.reshape(-1, padded.shape[-1]).contiguous()
    batch = sig.shape[0]
    _build.require_grid(batch, -(-t // TILE_FRAMES), name)
    ops = ops.to(padded.device).contiguous()
    lib = _build.library()
    chunks = lib.zt_cqt_chunks(length)
    part = (torch.empty((chunks, batch, t, f), dtype=torch.complex64,
                        device=padded.device) if chunks > 1 else None)
    out = torch.empty((batch, t, f), dtype=torch.float32,
                      device=padded.device)
    entry = "zt_" + name
    args = (sig.data_ptr(), ops.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(), batch,
            sig.shape[-1], t, length, step, f, fp)
    if split4:
        args += (_build.check_passes(passes, name),)
    err = getattr(lib, entry)(*args, _build.stream_of(padded))
    _build.check(err, entry)
    (cqt_magnitudes_split4 if split4 else cqt_magnitudes).launches += 1
    return out.reshape(*padded.shape[:-1], t, f)


for _fn in (cqt_magnitudes, cqt_magnitudes_split4):
    _fn.launches = 0
del _fn
