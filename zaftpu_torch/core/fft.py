"""DFT-as-GEMM operators and spectrum-layout helpers (the main-path subset
of ``zaftpu.core.fft``).

The operators are built on the host in numpy float64 with the same math as
``zaftpu.core.fft`` (so the arrays match bit for bit), cast to the compute
dtype, and uploaded once per ``(builder, args, device, dtype)``. The
conjugate mirror and the Hermitian fold are plain index ops on the re/im
planes, as they are XLA gathers outside any kernel in ``zaftpu``; under
``ZAFTPU_MIRROR=pallas`` the mirror of :func:`full_from_half` (and the
ISTFT's fold, :func:`zaftpu_torch.kernels.synthesis_ola`) go through
:mod:`zaftpu_torch.kernels.mirror`, whose plain versions are these.

Dtype follows the input: float32 in gives complex64 out, float64 (the CPU
oracle mode) gives complex128.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch.core.policy import presplit, presplit_host, real_matmul


@lru_cache(maxsize=8)
def _direct_rdft_mats(n: int, rdtype_name: str):
    """Host-precomputed ``(N, N/2+1)`` cos/sin DFT matrices (float64 math,
    cast to the target real dtype)."""
    k = np.arange(n // 2 + 1)
    ang = (-2.0 * np.pi / n) * ((np.arange(n)[:, None] * k[None, :]) % n)
    return (np.cos(ang).astype(rdtype_name), np.sin(ang).astype(rdtype_name))


@lru_cache(maxsize=8)
def _direct_ridft_half_mats(n: int, rdtype_name: str, scale: float = 1.0):
    """Host-precomputed ``(N/2+1, N)`` inverse-DFT cos/sin matrices over the
    non-mirrored bins, with the conjugate-pair weights (2 for interior bins,
    1 for DC and, when N is even, Nyquist), 1/N and ``scale`` (the COLA gain
    division, zaf.py:241) folded in."""
    half = n // 2 + 1
    k = np.arange(half)
    weights = np.full(half, 2.0)
    weights[0] = 1.0
    if n % 2 == 0:
        weights[-1] = 1.0
    ang = (2.0 * np.pi / n) * ((k[:, None] * np.arange(n)[None, :]) % n)
    row_scale = (weights * (float(scale) / n))[:, None]
    return ((np.cos(ang) * row_scale).astype(rdtype_name),
            (np.sin(ang) * row_scale).astype(rdtype_name))


@lru_cache(maxsize=32)
def device_operator(builder, args: tuple, device: torch.device,
                    dtype: torch.dtype, presplit: bool = False):
    """``builder(*args)`` uploaded to ``device`` as ``dtype``, once per key.

    ``builder`` returns a numpy array or a tuple of them (already in the
    target precision, so the upload only copies). ``presplit`` (the split4
    dial's operators) uploads the ``(2, ...)`` bf16 hi/lo stack of the
    float32 array instead (:func:`zaftpu_torch.core.policy.presplit_host`);
    the dial is part of the key."""
    host = builder(*args)
    if presplit:
        host = presplit_host(host)
    if isinstance(host, tuple):
        return tuple(torch.from_numpy(np.ascontiguousarray(h)).to(
            device=device, dtype=dtype) for h in host)
    return torch.from_numpy(np.ascontiguousarray(host)).to(device=device,
                                                           dtype=dtype)


def presplit_operator(ops: torch.Tensor | None, builder=None,
                      args: tuple = (), device=None) -> torch.Tensor:
    """A split4 twin's operator: ``ops`` as given when it is already the
    presplit bf16 stack, split on the host when it is float32, or when
    ``None`` the cached presplit stack of the float32 array
    ``builder(*args)`` on ``device``."""
    if ops is None:
        return device_operator(builder, args, torch.device(device),
                               torch.bfloat16, presplit=True)
    return ops if ops.dtype == torch.bfloat16 else presplit(ops)


def _real_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def operators_from_numpy(ops: np.ndarray, n: int, kind: str,
                         device=None) -> torch.Tensor:
    """The port's kernel operator from one of ``zaftpu``'s stacked operator
    arrays, so both packages can run on identical operators. ``n`` is the
    window length.

    ``kind="rdft"``: ``zaftpu.pallas.fused._rdft_ops_padded(n)``,
    ``(2, N, 128-lane F_pad)``, becomes the fused kernel's ``(2, N, F_pad)``
    with 64-bin padding.
    ``kind="spec"``: the same array becomes the magnitude kernels'
    ``(2, N, F_pad)`` over bins ``1..N/2`` (``kernels.melfused``).
    ``kind="istft"``: ``zaftpu.pallas.synth._istft_ops_padded(n, s)``,
    ``(2, 128-lane kpad, N)``, becomes the synthesis kernel's
    ``(2, KP, N)`` with 16-row padding.
    ``kind="mdct"``: ``zaftpu.transforms.mdct._direct_forward_ops_padded(n)``,
    ``(1, N, F_pad)``, becomes ``frames_op``'s ``(1, N, F_pad)`` with
    64-column padding, F = N/2.
    ``kind="imdct"``: ``zaftpu.pallas.synth._imdct_ops_padded(n/2, wbytes)``,
    ``(1, F, 2F)``, becomes ``imdct_ola``'s ``(Q, 2F)`` with Q = F rounded
    up to 16.
    Only the valid columns (rows) are carried; the padding is zero.
    """
    from zaftpu_torch.kernels import fused, synth

    f = n // 2 + 1
    ops = np.asarray(ops)
    if kind == "rdft":
        out = np.zeros((2, n, fused.padded_bins(n)), ops.dtype)
        out[:, :, :f] = ops[:, :n, :f]
    elif kind == "spec":
        out = np.zeros((2, n, fused.padded_cols(n // 2)), ops.dtype)
        out[:, :, :n // 2] = ops[:, :n, 1:f]
    elif kind == "istft":
        out = np.zeros((2, synth.padded_rows(n), n), ops.dtype)
        out[:, :f] = ops[:, :f, :n]
    elif kind == "mdct":
        out = np.zeros((1, n, fused.padded_cols(n // 2)), ops.dtype)
        out[:, :, :n // 2] = ops[:, :n, :n // 2]
    elif kind == "imdct":
        out = np.zeros((synth.padded_slices(n // 2), n), ops.dtype)
        out[:n // 2] = ops[0, :n // 2, :n]
    else:
        raise ValueError("kind must be 'rdft', 'spec', 'istft', 'mdct' or "
                         f"'imdct', got {kind!r}")
    return torch.from_numpy(out).to(device=device)


@lru_cache(maxsize=16)
def _mirror_index(half_len: int, n: int, device: torch.device):
    """Gather index for the mirrored interior bins:
    ``full[k] = conj(half[n - k])`` for ``k = half_len..n-1``."""
    return torch.arange(n - half_len, 0, -1, device=device)


@lru_cache(maxsize=16)
def _fold_index(n: int, device: torch.device):
    """Gather index for the Hermitian fold: bin ``(N - k) mod N`` for
    ``k = 0..N/2``."""
    k = torch.arange(n // 2 + 1, device=device)
    return (n - k) % n


def full_from_half(half: torch.Tensor, n: int) -> torch.Tensor:
    """Length-``n`` full spectrum from a half spectrum ``(..., n//2+1)``:
    :func:`conjugate_mirror`, or with ``ZAFTPU_MIRROR=pallas`` the mirror
    kernel's wrapper (``kernels.mirror.mirror_full_planes``), as
    ``zaftpu.core.fft.full_from_half`` dispatches."""
    from zaftpu_torch.kernels import mirror  # the kernels import this module

    if mirror.enabled():
        return mirror.mirror_full_planes(half, n)
    return conjugate_mirror(half, n)


def conjugate_mirror(half: torch.Tensor, n: int) -> torch.Tensor:
    """Appends the mirrored conjugate bins ``full[k] = conj(half[n - k])``
    so the result matches ``np.fft.fft`` of the real frames (the
    reference's convention, zaf.py:139), built from index gathers on the
    re/im planes."""
    re, im = half.real, half.imag
    idx = _mirror_index(half.shape[-1], n, half.device)
    return torch.complex(torch.cat([re, re[..., idx]], dim=-1),
                         torch.cat([im, -im[..., idx]], dim=-1))


def hermitian_fold_planes(zr: torch.Tensor, zi: torch.Tensor, n: int):
    """The Hermitian fold ``H_k = (Z_k + conj(Z_{(N-k) mod N})) / 2``,
    ``k = 0..N/2``, on (re, im) planes over the last axis. ``real(ifft(Z))``
    equals the inverse rDFT of the fold for any complex Z, Hermitian or not
    (zaftpu.core.fft.direct_real_ifft)."""
    half = n // 2 + 1
    idx = _fold_index(n, zr.device)
    return (0.5 * (zr[..., :half] + zr[..., idx]),
            0.5 * (zi[..., :half] - zi[..., idx]))


def rdft_mats(n: int, dtype: torch.dtype, device) -> tuple:
    """The ``(N, N/2+1)`` cos/sin pair on ``device`` in ``dtype``."""
    return device_operator(_direct_rdft_mats, (n, _real_name(dtype)),
                           torch.device(device), dtype)


def ridft_half_mats(n: int, dtype: torch.dtype, device,
                    scale: float = 1.0) -> tuple:
    """The ``(N/2+1, N)`` inverse cos/sin pair on ``device`` in ``dtype``."""
    return device_operator(_direct_ridft_half_mats,
                           (n, _real_name(dtype), float(scale)),
                           torch.device(device), dtype)


def direct_rfft(x: torch.Tensor) -> torch.Tensor:
    """Real DFT of frames ``(..., N)`` as two GEMMs against the cos/sin
    operators: ``X = x @ C + i * (x @ S)``, ``(..., N/2+1)`` complex. The
    GEMMs honour the precision dial (``policy.real_matmul``), as
    ``zaftpu.core.fft.direct_rfft``'s do."""
    cos_m, sin_m = rdft_mats(x.shape[-1], x.dtype, x.device)
    return torch.complex(real_matmul(x, cos_m), real_matmul(x, sin_m))


def direct_real_ifft_folded(h_re: torch.Tensor, h_im: torch.Tensor, n: int,
                            scale: float = 1.0) -> torch.Tensor:
    """``h_re @ C - h_im @ S`` over pre-folded planes ``(..., N/2+1)``:
    frames ``(..., N)`` of ``real(ifft(Z)) * scale``, the GEMMs honouring
    the precision dial."""
    cos_m, sin_m = ridft_half_mats(n, h_re.dtype, h_re.device, scale)
    return real_matmul(h_re, cos_m) - real_matmul(h_im, sin_m)


def direct_real_ifft(z: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``real(ifft(Z)) * scale`` along the last axis, for any complex Z
    (masked, non-Hermitian spectra included): the Hermitian fold, then two
    half-width GEMMs."""
    n = z.shape[-1]
    h_re, h_im = hermitian_fold_planes(z.real, z.imag, n)
    return direct_real_ifft_folded(h_re, h_im, n, scale)


def real_ifft(spectra: torch.Tensor) -> torch.Tensor:
    """``real(ifft(X))`` along the last axis (reference zaf.py:223): a full
    complex inverse, never ``irfft``, so non-Hermitian input keeps its
    meaning."""
    return direct_real_ifft(spectra)
