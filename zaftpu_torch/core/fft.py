"""The FFT layer: ``rfft``, ``fft``, ``ifft`` and ``real_ifft`` with
``zaftpu.core.fft``'s routing, the four-step engine, the DFT-as-GEMM
operators and the spectrum-layout helpers.

Routing (``zaftpu.core.fft``'s levers): ``ZAFTPU_FFT=auto`` (the default)
selects the matmul engine on CUDA and ``torch.fft`` on the CPU, ``matmul``
the engine everywhere, ``native`` ``torch.fft`` everywhere. On the engine a
real transform up to :data:`DIRECT_MAX` (4096) is one GEMM pair against the
cos/sin operators. Past it ``auto`` runs ``torch.fft``, the card's own FFT,
at every length. ``matmul`` runs ``zaftpu``'s four-step (Bailey) engine at
a power of two and ``torch.fft`` at any other length, as ``zaftpu`` runs
``jnp.fft`` there: the TPU has no FFT unit, so ``zaftpu`` takes the engine
by default, and the port keeps it behind the lever, where it reproduces
``zaftpu``'s arithmetic. The engine is plain PyTorch, as it is plain XLA in
``zaftpu``: every real product goes through the exact GEMM
(``policy.exact_matmul``: true FP32, the contraction summed in 256-wide
blocks, TF32 refused), the complex stages as real GEMMs on the re/im planes
against ``[[Re W, Im W], [-Im W, Re W]]`` block operators, never a complex
GEMM; only a real input's first stage honours the split4 dial
(``policy.real_matmul``), as in ``zaftpu``.

The operators are built on the host in numpy float64 with the same math as
``zaftpu.core.fft`` (the direct GEMM's match bit for bit; the four-step
factors reduce each exponent modulo the length first), cast to the compute
dtype, and uploaded once per ``(builder, args, device, dtype)``. The
conjugate mirror and the Hermitian fold are plain index ops on the re/im
planes, as they are XLA gathers outside any kernel in ``zaftpu``; under
``ZAFTPU_MIRROR=pallas`` the mirror of :func:`full_from_half` (and the
ISTFT's fold, :func:`zaftpu_torch.kernels.synthesis_ola`) go through
:mod:`zaftpu_torch.kernels.mirror`, whose plain versions are these. By
default the ISTFT's fold at every window the inverse real-FFT kernel
takes (16 to 4096) is read in that kernel's load
(:func:`zaftpu_torch.kernels.irfft.istft_ola_fft_full`), in this fold's
order; these index ops serve the GEMM routes.

Dtype follows the input: float32 in gives complex64 out, float64 (the CPU
oracle mode) gives complex128.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch.core.policy import (exact_matmul, presplit, presplit_host,
                                     real_matmul)


def engine_selected(device) -> bool:
    """Is the matmul engine the FFT for tensors on ``device``?
    ``ZAFTPU_FFT``: ``auto`` (default) on CUDA, not on the CPU, where
    ``torch.fft`` is the float64 oracle; ``matmul`` everywhere; ``native``
    nowhere."""
    mode = os.environ.get("ZAFTPU_FFT", "auto")
    if mode == "matmul":
        return True
    return mode == "auto" and torch.device(device).type == "cuda"


# The direct GEMM's limit: zaftpu's default ZAFTPU_FFT_DIRECT_MAX, and the
# largest window of the FFT kernels (kernels.rfft.MAX_WINDOW).
DIRECT_MAX = 4096


def direct_engine_enabled(n: int, device) -> bool:
    """Does the engine's direct GEMM cover length ``n`` on ``device``? Any
    ``n`` from 2 to :data:`DIRECT_MAX`, powers of two or not."""
    return engine_selected(device) and 2 <= n <= DIRECT_MAX


def _use_matmul_engine(n: int) -> bool:
    """Route this length through the four-step engine: under
    ``ZAFTPU_FFT=matmul``, a power of two of at least 4."""
    return (os.environ.get("ZAFTPU_FFT", "auto") == "matmul"
            and n >= 4 and n & (n - 1) == 0)


def _pad_or_trim(x: torch.Tensor, n: int) -> torch.Tensor:
    if n <= x.shape[-1]:
        return x[..., :n]
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def rfft(frames: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Real FFT along the last axis, ``(..., N)`` -> ``(..., N//2 + 1)``:
    the direct GEMM, the four-step engine (``ZAFTPU_FFT=matmul``) or
    ``torch.fft.rfft``."""
    if n is not None and n != frames.shape[-1]:
        frames = _pad_or_trim(frames, n)
    length = frames.shape[-1]
    if not frames.is_complex() and direct_engine_enabled(length,
                                                          frames.device):
        return direct_rfft(frames)
    if _use_matmul_engine(length):
        return matmul_rfft(frames)
    return torch.fft.rfft(frames, dim=-1)


def fft(frames: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Full complex FFT along the last axis: the four-step engine
    (``ZAFTPU_FFT=matmul``) or ``torch.fft.fft``."""
    if n is not None and n != frames.shape[-1]:
        frames = _pad_or_trim(frames, n)
    if _use_matmul_engine(frames.shape[-1]):
        return matmul_fft(frames)
    return torch.fft.fft(frames, dim=-1)


def ifft(spectra: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Full complex inverse FFT along the last axis: the four-step engine
    (``ZAFTPU_FFT=matmul``) or ``torch.fft.ifft``."""
    if n is not None and n != spectra.shape[-1]:
        spectra = _pad_or_trim(spectra, n)
    if _use_matmul_engine(spectra.shape[-1]):
        return matmul_ifft(spectra)
    return torch.fft.ifft(spectra, dim=-1)


@lru_cache(maxsize=16)
def _four_step_factors(n: int):
    """``n = n1 * n2`` (powers of two, ``n1 = 2^(log2 n // 2)``) and the
    complex float64 ``W1 (n1, n1)``, ``W2 (n2, n2)`` and twiddle ``(n1,
    n2)`` matrices."""
    if n & (n - 1):
        raise ValueError(f"matmul_fft needs a power-of-two length, got {n}")
    log = n.bit_length() - 1
    n1 = 1 << (log // 2)
    n2 = n // n1

    def dft(rows: int, cols: int, size: int) -> np.ndarray:
        k = np.outer(np.arange(rows), np.arange(cols)) % size
        return np.exp((-2j * np.pi / size) * k)

    return n1, n2, dft(n1, n1, n1), dft(n2, n2, n2), dft(n1, n2, n)


def _block(w: np.ndarray) -> np.ndarray:
    """``[[Re W, Im W], [-Im W, Re W]]``: ``[re | im] @`` it is ``[Re(z W)
    | Im(z W)]`` for the rows ``z = re + i im``."""
    return np.block([[w.real, w.imag], [-w.imag, w.real]])


@lru_cache(maxsize=8)
def _four_step_ops(n: int, rdtype_name: str):
    """The four-step operators in the target real dtype: ``Re W2``, ``Im
    W2``, the block of ``W2``, the twiddle's re and im, the block of
    ``W1``."""
    _, _, w1, w2, tw = _four_step_factors(n)
    return tuple(a.astype(rdtype_name) for a in (
        w2.real, w2.imag, _block(w2), tw.real, tw.imag, _block(w1)))


def _four_step_planes(xr: torch.Tensor, xi: torch.Tensor | None) -> tuple:
    """(re, im) of the FFT of ``xr + i xi`` (``xi`` None: real input) along
    the last axis, a power of two: with ``A[i1, i2] = x[i1 + n1 i2]``,
    ``X[k2 + n2 k1] = sum_i1 W1[i1, k1] Tw[i1, k2] sum_i2 A[i1, i2] W2[i2,
    k2]``."""
    *lead, n = xr.shape
    n1, n2 = _four_step_factors(n)[:2]
    w2r, w2i, w2b, twr, twi, w1b = device_operator(
        _four_step_ops, (n, _real_name(xr.dtype)), xr.device, xr.dtype)
    ar = xr.reshape(*lead, n2, n1).transpose(-1, -2)
    if xi is None:
        # A real first stage: two real GEMMs, which split4 may lower.
        br, bi = real_matmul(ar, w2r), real_matmul(ar, w2i)
    else:
        ai = xi.reshape(*lead, n2, n1).transpose(-1, -2)
        b = exact_matmul(torch.cat([ar, ai], dim=-1), w2b)
        br, bi = b[..., :n2], b[..., n2:]
    # The twiddle, then the second stage over i1 with the rows (k2, i1).
    cr = (br * twr - bi * twi).transpose(-1, -2)
    ci = (br * twi + bi * twr).transpose(-1, -2)
    c = exact_matmul(torch.cat([cr, ci], dim=-1), w1b)
    return (c[..., :n1].transpose(-1, -2).reshape(*lead, n),
            c[..., n1:].transpose(-1, -2).reshape(*lead, n))


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype of a real compute dtype: complex64 for float32,
    complex128 for float64."""
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def _real_input(x: torch.Tensor) -> torch.Tensor:
    """A real input at least float32 (bfloat16 computes in float32)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def matmul_fft(x: torch.Tensor) -> torch.Tensor:
    """Full complex FFT along the last axis by the four-step engine
    (``zaftpu.core.fft.matmul_fft``), a power-of-two length; real or
    complex input, complex64 or complex128 out."""
    if x.is_complex():
        return torch.complex(*_four_step_planes(x.real, x.imag))
    return torch.complex(*_four_step_planes(_real_input(x), None))


def matmul_rfft(x: torch.Tensor) -> torch.Tensor:
    """Real-input bins ``0..N/2`` by the four-step engine: batched rows
    pair-packed (:func:`_packed_rfft`), a single row through
    :func:`matmul_fft`."""
    if x.ndim >= 2 and x.shape[-2] >= 2 and not x.is_complex():
        return _packed_rfft(x)
    return matmul_fft(x)[..., :x.shape[-1] // 2 + 1]


def _packed_rfft(x: torch.Tensor) -> torch.Tensor:
    """Batched rfft over the last axis, adjacent rows along axis -2 packed
    as one complex row ``x_even + i x_odd`` (an odd count padded with a
    zero row) and unpacked by conjugate symmetry: ``X_even[k] = (Z[k] +
    conj Z[-k]) / 2``, ``X_odd[k] = (Z[k] - conj Z[-k]) / 2i``."""
    x = _real_input(x)
    *lead, b, n = x.shape
    half = n // 2 + 1
    if b % 2:
        x = torch.nn.functional.pad(x, (0, 0, 0, 1))
    fr, fi = _four_step_planes(x[..., 0::2, :], x[..., 1::2, :])
    idx = _fold_index(n, x.device)  # (n - k) mod n, k = 0..n/2
    hr, hi = fr[..., :half], fi[..., :half]
    rr, ri = fr[..., idx], fi[..., idx]
    even_r, even_i = 0.5 * (hr + rr), 0.5 * (hi - ri)
    odd_r, odd_i = 0.5 * (hi + ri), -0.5 * (hr - rr)
    out = torch.stack([torch.complex(even_r, even_i),
                       torch.complex(odd_r, odd_i)], dim=-2)
    return out.reshape(*lead, -1, half)[..., :b, :]


def matmul_ifft(x: torch.Tensor) -> torch.Tensor:
    """Inverse FFT by the four-step engine: ``conj(FFT(conj X)) / N``."""
    n = x.shape[-1]
    if x.is_complex():
        yr, yi = _four_step_planes(x.real, -x.imag)
    else:
        yr, yi = _four_step_planes(_real_input(x), None)
    return torch.complex(yr / n, -yi / n)


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
    meaning. The direct GEMM pair where the engine's direct mode covers the
    length, else :func:`ifft`."""
    if direct_engine_enabled(spectra.shape[-1], spectra.device):
        return direct_real_ifft(spectra)
    return ifft(spectra).real
