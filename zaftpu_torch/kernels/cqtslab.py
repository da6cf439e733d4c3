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
bit for bit. The bf16 split4 twin (``_kernel_split4``) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from zaftpu_torch.core.policy import exact_matmul
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels.fused import TILE_FRAMES, padded_cols

CUDA_SOURCE = "zaftpu_torch/csrc/cqtslab.cu"
REPLACES = "zaftpu/pallas/cqtslab.py:290"  # magnitudes_in_trace


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


def slab_needed(number_times: int, step: int, fft_length: int) -> int:
    """Samples the slab loop reads: every slab view spans ``T * step``
    samples, so coverage rounds ``fft_length`` up to whole hops
    (``zaftpu``'s ``cqt._blocked_needed``)."""
    return (number_times - 1) * step + -(-fft_length // step) * step


def cqt_magnitudes_plain(padded: torch.Tensor, ops: torch.Tensor, step: int,
                         fft_length: int, number_times: int,
                         f_channels: int) -> torch.Tensor:
    """``(..., T, F)`` CQT magnitudes in plain PyTorch: the slab loop, each
    slab product an :func:`exact_matmul`, slabs added in ascending order,
    then ``sqrt(re² + im²)``. A signal shorter than the slabs' reach is
    zero-extended."""
    cqt_magnitudes_plain.calls += 1
    t, f, length = number_times, f_channels, fft_length
    need = slab_needed(t, step, length)
    if padded.shape[-1] < need:
        padded = torch.nn.functional.pad(padded,
                                         (0, need - padded.shape[-1]))
    lead = padded.shape[:-1]
    ops = ops.to(padded.dtype)
    re = im = None
    for lo in range(0, length, step):
        width = min(step, length - lo)
        slab = padded[..., lo:lo + t * step].reshape(*lead, t, step)
        slab = slab[..., :width]
        pr = exact_matmul(slab, ops[0, lo:lo + width, :f])
        pi = exact_matmul(slab, ops[1, lo:lo + width, :f])
        re = pr if re is None else re + pr
        im = pi if im is None else im + pi
    return torch.sqrt(re * re + im * im)


cqt_magnitudes_plain.calls = 0


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


def _cqt_magnitudes_cuda(padded: torch.Tensor, ops: torch.Tensor, step: int,
                         fft_length: int, number_times: int,
                         f_channels: int) -> torch.Tensor:
    """Check the CUDA input, launch the kernels, count the launch."""
    _build.require_f32(padded, "cqt_magnitudes")
    t, f, length = number_times, f_channels, fft_length
    fp = padded_cols(f)
    if step < 1 or t < 1 or f < 1:
        raise ValueError(f"cqt_magnitudes: need step, T and F >= 1, got "
                         f"{step}, {t} and {f}")
    if ops.shape != (2, length, fp) or ops.dtype != torch.float32:
        raise ValueError(f"cqt_magnitudes: operator must be float32 "
                         f"(2, {length}, {fp}), got {ops.dtype} "
                         f"{tuple(ops.shape)}")
    if padded.shape[-1] < (t - 1) * step + length:
        raise ValueError(f"cqt_magnitudes: {padded.shape[-1]} samples hold "
                         f"fewer than {t} frames of {length} at hop {step}")
    sig = padded.reshape(-1, padded.shape[-1]).contiguous()
    batch = sig.shape[0]
    _build.require_grid(batch, -(-t // TILE_FRAMES), "cqt_magnitudes")
    ops = ops.to(padded.device).contiguous()
    lib = _build.library()
    chunks = lib.zt_cqt_chunks(length)
    part = (torch.empty((chunks, batch, t, f), dtype=torch.complex64,
                        device=padded.device) if chunks > 1 else None)
    out = torch.empty((batch, t, f), dtype=torch.float32,
                      device=padded.device)
    err = lib.zt_cqt_magnitudes(
        sig.data_ptr(), ops.data_ptr(),
        None if part is None else part.data_ptr(), out.data_ptr(), batch,
        sig.shape[-1], t, length, step, f, fp, _build.stream_of(padded))
    _build.check(err, "zt_cqt_magnitudes")
    cqt_magnitudes.launches += 1
    return out.reshape(*padded.shape[:-1], t, f)


cqt_magnitudes.launches = 0
