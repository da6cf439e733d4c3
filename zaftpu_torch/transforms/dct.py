"""Orthonormal DCT and DST, types I-IV, batched over leading axes.

Semantics match ``zaftpu.transforms.dct`` and the reference
(zaf.py:703-981), equal to ``scipy.fftpack.dct/dst(norm="ortho")``. Where
the FFT layer's engine runs its direct GEMM at this length
(:func:`zaftpu_torch.core.fft.direct_engine_enabled`: up to 4096, on CUDA
and on the CPU under ``ZAFTPU_FFT=matmul``) each transform is one product
with its ``(N, N)`` operator, the float64 closed forms of ``zaftpu``'s
``_direct_matrix`` cast to the input's dtype, through
``policy.real_matmul`` (the split4 dial lowers it, as in ``zaftpu``).
Elsewhere the reference's zero-embedded real FFTs of length 2N-2, 2N+2, 4N
or 8N run on
:func:`zaftpu_torch.core.fft.rfft` (``torch.fft``; the four-step engine
at a power of two under ``ZAFTPU_FFT=matmul``). No TPU kernel is on this
path.

Inverse pairs: I<->I, II<->III, IV<->IV. Device rule as
:func:`zaftpu_torch.stft`: a tensor stays on its device and keeps its
dtype, anything else goes to the card as float32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch import kernels as _kernels
from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core import validate as _validate
from zaftpu_torch.core.policy import real_matmul
from zaftpu_torch.transforms.stft import _as_input

_SQRT2 = np.sqrt(2.0)


@lru_cache(maxsize=32)
def _direct_matrix(kind: str, transform_type: int, n: int) -> np.ndarray:
    """The orthonormal DCT/DST as one ``(N, N)`` matrix, ``y = x @ M``
    (float64 host math, ``zaftpu``'s closed forms; types III are the
    transposes of types II)."""
    j = np.arange(n, dtype=np.float64)[:, None]  # input sample index
    k = np.arange(n, dtype=np.float64)[None, :]  # output coefficient index
    if kind == "dct":
        if transform_type == 1:
            s = np.ones(n)
            s[0] = s[-1] = 1.0 / _SQRT2
            return (np.sqrt(2.0 / (n - 1)) * (s[:, None] * s[None, :])
                    * np.cos(np.pi * j * k / (n - 1)))
        if transform_type == 2:
            c = np.ones(n)
            c[0] = 1.0 / _SQRT2
            return (np.sqrt(2.0 / n) * c[None, :]
                    * np.cos(np.pi * (2 * j + 1) * k / (2 * n)))
        if transform_type == 3:
            return np.ascontiguousarray(_direct_matrix("dct", 2, n).T)
        return (np.sqrt(2.0 / n)
                * np.cos(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n)))
    if transform_type == 1:
        return (np.sqrt(2.0 / (n + 1))
                * np.sin(np.pi * (j + 1) * (k + 1) / (n + 1)))
    if transform_type == 2:
        d = np.ones(n)
        d[-1] = 1.0 / _SQRT2
        return (np.sqrt(2.0 / n) * d[None, :]
                * np.sin(np.pi * (2 * j + 1) * (k + 1) / (2 * n)))
    if transform_type == 3:
        return np.ascontiguousarray(_direct_matrix("dst", 2, n).T)
    return (np.sqrt(2.0 / n)
            * np.sin(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n)))


def _apply_direct(x: torch.Tensor, kind: str,
                  transform_type: int) -> torch.Tensor:
    matrix = _fft.device_operator(_direct_matrix,
                                  (kind, transform_type, x.shape[-1]),
                                  x.device, x.dtype)
    return real_matmul(x, matrix)


def _scaled(x: torch.Tensor, index: int, factor: float) -> torch.Tensor:
    """``x`` with element ``index`` of the last axis times ``factor``."""
    x = x.clone()
    x[..., index] *= factor
    return x


def _embed(x: torch.Tensor, length: int, placements) -> torch.Tensor:
    """Zeros of last dim ``length`` with ``(slice, values)`` placed."""
    out = x.new_zeros((*x.shape[:-1], length))
    for sl, vals in placements:
        out[..., sl] = vals
    return out


def _dct_core(x: torch.Tensor, dct_type: int) -> torch.Tensor:
    """The reference's zero-embedded real FFTs (zaftpu dct.py:124-161)."""
    n = x.shape[-1]
    rev = x.flip(-1)
    if dct_type == 1:
        # Symmetric 2N-2 extension, endpoints scaled by sqrt(2) and back.
        xe = _scaled(_scaled(x, 0, _SQRT2), n - 1, _SQRT2)
        emb = torch.cat([xe, xe[..., 1:-1].flip(-1)], dim=-1)
        y = _fft.rfft(emb).real[..., :n] / 2.0
        y = _scaled(_scaled(y, 0, 1.0 / _SQRT2), n - 1, 1.0 / _SQRT2)
        return y * float(np.sqrt(2.0 / (n - 1)))
    if dct_type == 2:
        emb = _embed(x, 4 * n, [(slice(1, 2 * n, 2), x),
                                (slice(2 * n + 1, 4 * n, 2), rev)])
        y = _fft.rfft(emb).real[..., :n] / 2.0
        return _scaled(y, 0, 1.0 / _SQRT2) * float(np.sqrt(2.0 / n))
    if dct_type == 3:
        xe = _scaled(x, 0, _SQRT2)
        reve = xe.flip(-1)
        emb = _embed(xe, 4 * n, [(slice(0, n), xe),
                                 (slice(n + 1, 2 * n + 1), -reve),
                                 (slice(2 * n + 1, 3 * n), -xe[..., 1:]),
                                 (slice(3 * n + 1, 4 * n), reve[..., :-1])])
        y = _fft.rfft(emb).real[..., 1:2 * n:2] / 4.0
        return y * float(np.sqrt(2.0 / n))
    emb = _embed(x, 8 * n, [(slice(1, 2 * n, 2), x),
                            (slice(2 * n + 1, 4 * n, 2), -rev),
                            (slice(4 * n + 1, 6 * n, 2), -x),
                            (slice(6 * n + 1, 8 * n, 2), rev)])
    y = _fft.rfft(emb).real[..., 1:2 * n:2] / 4.0
    return y * float(np.sqrt(2.0 / n))


def _dst_core(x: torch.Tensor, dst_type: int) -> torch.Tensor:
    """The reference's zero-embedded real FFTs (zaftpu dct.py:164-198)."""
    n = x.shape[-1]
    rev = x.flip(-1)
    if dst_type == 1:
        emb = _embed(x, 2 * n + 2, [(slice(1, n + 1), x),
                                    (slice(n + 2, 2 * n + 2), -rev)])
        y = -_fft.rfft(emb).imag[..., 1:n + 1] / 2.0
        return y * float(np.sqrt(2.0 / (n + 1)))
    if dst_type == 2:
        emb = _embed(x, 4 * n, [(slice(1, 2 * n, 2), x),
                                (slice(2 * n + 1, 4 * n, 2), -rev)])
        y = -_fft.rfft(emb).imag[..., 1:n + 1] / 2.0
        return _scaled(y, n - 1, 1.0 / _SQRT2) * float(np.sqrt(2.0 / n))
    if dst_type == 3:
        xe = _scaled(x, n - 1, _SQRT2)
        reve = xe.flip(-1)
        emb = _embed(xe, 4 * n, [(slice(1, n + 1), xe),
                                 (slice(n + 1, 2 * n), reve[..., 1:]),
                                 (slice(2 * n + 1, 3 * n + 1), -xe),
                                 (slice(3 * n + 1, 4 * n), -reve[..., 1:])])
        y = -_fft.rfft(emb).imag[..., 1:2 * n:2] / 4.0
        return y * float(np.sqrt(2.0 / n))
    emb = _embed(x, 8 * n, [(slice(1, 2 * n, 2), x),
                            (slice(2 * n + 1, 4 * n, 2), rev),
                            (slice(4 * n + 1, 6 * n, 2), -x),
                            (slice(6 * n + 1, 8 * n, 2), -rev)])
    y = -_fft.rfft(emb).imag[..., 1:2 * n:2] / 4.0
    return y * float(np.sqrt(2.0 / n))


def _transform(kind: str, audio_signal, transform_type, core):
    x = _validate.check_signal(_as_input(audio_signal))
    if int(transform_type) not in (1, 2, 3, 4):
        raise ValueError(f"{kind}_type must be 1..4, got {transform_type}")
    transform_type = int(transform_type)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    _kernels.check_device_input(x)
    if _fft.direct_engine_enabled(x.shape[-1], x.device):
        return _apply_direct(x, kind, transform_type)
    return core(x, transform_type)


def dct(audio_signal, dct_type: int) -> torch.Tensor:
    """Orthonormal DCT of type 1-4 along the last axis: ``(..., N)`` in,
    ``(..., N)`` out, ``scipy.fftpack.dct(x, type, norm="ortho")``
    (reference zaf.py:703-839)."""
    return _transform("dct", audio_signal, dct_type, _dct_core)


def dst(audio_signal, dst_type: int) -> torch.Tensor:
    """Orthonormal DST of type 1-4 along the last axis: ``(..., N)`` in,
    ``(..., N)`` out, ``scipy.fftpack.dst(x, type, norm="ortho")``
    (reference zaf.py:842-981)."""
    return _transform("dst", audio_signal, dst_type, _dst_core)
