"""The conjugate mirror and the Hermitian fold: CUDA kernels
(``csrc/mirror.cu``) and their plain versions.

``mirror_full_planes`` replaces ``zaftpu/pallas/mirror.py:
mirror_full_planes`` (B11a): a ``(..., n/2+1)`` half spectrum to the full
``(..., n)`` spectrum, ``full[k] = conj(half[n - k])`` above n/2.
``fold_half_planes`` replaces its ``fold_half_planes`` (B11b): the fold
``H_k = (Z_k + conj(Z_{(n-k) mod n})) / 2``, ``k = 0..n/2``, as re and im
planes. The plain versions are :mod:`zaftpu_torch.core.fft`'s index ops,
and the kernels are bit-equal to them.

``ZAFTPU_MIRROR=pallas`` is ``zaftpu``'s lever: ``stft``'s mirror
(:func:`zaftpu_torch.core.fft.full_from_half`) and the ISTFT's fold
(:func:`zaftpu_torch.kernels.synthesis_ola`) then go through these wrappers.
Unlike ``zaftpu``'s, the kernels take any n and any leading axes; the
``rev``/``dot`` strategies (``ZAFTPU_MIRROR_STRATEGY``) have no counterpart,
since a reversal is index arithmetic here.
"""

from __future__ import annotations

import os

import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.kernels import _build

CUDA_SOURCE = "zaftpu_torch/csrc/mirror.cu"
REPLACES_MIRROR = "zaftpu/pallas/mirror.py:87"  # mirror_full_planes
REPLACES_FOLD = "zaftpu/pallas/mirror.py:141"   # fold_half_planes


def enabled() -> bool:
    """``ZAFTPU_MIRROR``: the kernels only when set to ``pallas``."""
    return os.environ.get("ZAFTPU_MIRROR") == "pallas"


def mirror_full_planes_plain(half: torch.Tensor, n: int) -> torch.Tensor:
    """The full spectrum from index gathers, in plain PyTorch."""
    mirror_full_planes_plain.calls += 1
    return _fft.conjugate_mirror(half, n)


mirror_full_planes_plain.calls = 0


def mirror_full_planes(half: torch.Tensor, n: int) -> torch.Tensor:
    """Length-``n`` full spectrum ``(..., n)`` from a half spectrum
    ``(..., n//2+1)``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened) or raises.
    """
    if not half.is_cuda:
        return mirror_full_planes_plain(half, n)
    return _mirror_full_planes_cuda(half, n)


def _mirror_full_planes_cuda(half: torch.Tensor, n: int) -> torch.Tensor:
    """Check the CUDA input, launch the kernel, count the launch."""
    if half.dtype != torch.complex64:
        raise NotImplementedError(
            f"mirror_full_planes: the CUDA kernel takes complex64, got "
            f"{half.dtype}")
    if n < 1 or half.ndim < 1 or half.shape[-1] != n // 2 + 1:
        raise ValueError(f"mirror_full_planes: need a (..., {n // 2 + 1}) "
                         f"half spectrum for n = {n}, got "
                         f"{tuple(half.shape)}")
    src = half.contiguous()
    out = torch.empty((*half.shape[:-1], n), dtype=torch.complex64,
                      device=half.device)
    rows = src.numel() // src.shape[-1]
    if rows:
        err = _build.library().zt_mirror_full(
            src.data_ptr(), out.data_ptr(), rows, n, _build.stream_of(half))
        _build.check(err, "zt_mirror_full")
        mirror_full_planes.launches += 1
    return out


mirror_full_planes.launches = 0


def fold_half_planes_plain(z: torch.Tensor, n: int):
    """The Hermitian fold of ``z`` ``(..., n)`` as ``(h_re, h_im)`` planes
    ``(..., n//2+1)``, from index gathers in plain PyTorch."""
    fold_half_planes_plain.calls += 1
    return _fft.hermitian_fold_planes(z.real, z.imag, n)


fold_half_planes_plain.calls = 0


def fold_half_planes(z: torch.Tensor, n: int):
    """Hermitian fold of a complex ``(..., n)`` spectrum, frames-major and
    strided as it may be (``synthesis_ola`` passes the transposed view of a
    bins-major spectrum), into contiguous ``(h_re, h_im)`` planes
    ``(..., n//2+1)``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if not z.is_cuda:
        return fold_half_planes_plain(z, n)
    return _fold_half_planes_cuda(z, n)


def _fold_half_planes_cuda(z: torch.Tensor, n: int):
    """Check the CUDA input, launch the kernel, count the launch."""
    if z.dtype != torch.complex64:
        raise NotImplementedError(
            f"fold_half_planes: the CUDA kernel takes complex64, got "
            f"{z.dtype}")
    if n < 1 or z.ndim < 1 or z.shape[-1] != n:
        raise ValueError(f"fold_half_planes: need a (..., {n}) spectrum, "
                         f"got {tuple(z.shape)}")
    t = z.shape[-2] if z.ndim > 1 else 1
    # A view wherever the leading axes allow; the kernel takes its strides.
    z3 = z.reshape(z.numel() // max(1, t * n), t, n)
    h = n // 2 + 1
    h_re = torch.empty((*z.shape[:-1], h), dtype=torch.float32,
                       device=z.device)
    h_im = torch.empty_like(h_re)
    rows = z3.shape[0] * t
    if rows:
        sb, st, sk = z3.stride()
        err = _build.library().zt_fold_half(
            z3.data_ptr(), h_re.data_ptr(), h_im.data_ptr(), rows, t, n, sb,
            st, sk, _build.stream_of(z))
        _build.check(err, "zt_fold_half")
        fold_half_planes.launches += 1
    return h_re, h_im


fold_half_planes.launches = 0
