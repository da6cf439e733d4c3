"""Framing + window + real FFT: the CUDA kernel (``csrc/rfft.cu``) and its
plain version.

It computes what ``zaftpu/pallas/fused.py: _frames_matmul_impl`` computes as
``frames_rfft`` reaches it (B1), and ``_frames_matmul2_impl`` (B12): the
half spectrum ``X[t, k] = sum_w sig[t*step + w] * win[w] * exp(-2 pi i k w /
N)``, ``k = 0..N/2``, as interleaved complex (:func:`frames_rfft_fft`) or as
two float32 planes (:func:`frames_matmul2_fft`). The TPU kernels contract
each frame with a dense cos/sin operator; this one runs an FFT, so it is
bound by its bytes, not by FP32 arithmetic.

:func:`applies` is the shape rule that :mod:`zaftpu_torch.kernels.fused`
uses to send the exact dial here: a window length that is a power of two
from :data:`MIN_WINDOW` to :data:`MAX_WINDOW` and no explicit operator. The
plain version repeats the kernel's arithmetic (the same even/odd packing,
radix-4/radix-2 Stockham passes in the same order, the same twiddle table,
the same split step), operation by operation, so the CPU tests exercise the
kernel's indexing and the kernel equals it on the card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core.frame import extract_frames
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels.framing import check_frame_args

CUDA_SOURCE = "zaftpu_torch/csrc/rfft.cu"
REPLACES = "zaftpu/pallas/fused.py:279"  # _frames_matmul_impl (frames_rfft)
REPLACES_2 = "zaftpu/pallas/fused.py:367"  # _frames_matmul2_impl

MIN_WINDOW = 16
# The CUDA path's largest window (zaftpu_torch.kernels.MAX_WINDOW): the
# direct DFT GEMM's, and this kernel's 2,048 complex values per block.
MAX_WINDOW = 4096


def applies(window_length: int, ops=None) -> bool:
    """The shape rule: the FFT kernel computes the half spectrum when the
    window length is a power of two in ``[MIN_WINDOW, MAX_WINDOW]`` and no
    operator is given (an explicit ``ops`` names the GEMM kernels)."""
    n = int(window_length)
    return (ops is None and MIN_WINDOW <= n <= MAX_WINDOW
            and n & (n - 1) == 0)


@lru_cache(maxsize=8)
def _twiddles(n: int, rdtype_name: str = "float32") -> np.ndarray:
    """``(N, 2)`` table of ``W_N^j = exp(-2 pi i j / N)``, ``j < N``, as
    (cos, sin): float64 math rounded once to the target dtype."""
    ang = (-2.0 * np.pi / n) * np.arange(n)
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(rdtype_name)


def twiddles(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    return _fft.device_operator(_twiddles, (n, _fft._real_name(dtype)),
                                torch.device(device), dtype)


def radices(m: int) -> tuple:
    """The Stockham passes of an ``m``-point complex FFT: radix 4 while it
    fits, then one radix-2 pass when ``log2 m`` is odd."""
    log_m = m.bit_length() - 1
    return (4,) * (log_m // 2) + (2,) * (log_m % 2)


def _stage(re, im, tw_re, tw_im, n, ns, r):
    """One radix-``r`` Stockham pass over the last axis (``m`` = N/2 points,
    sub-transforms of length ``ns`` growing to ``ns * r``): ``csrc/rfft.cu``
    ``stage``, vectorised. Input ``s`` is the slice ``[s q, (s+1) q)``;
    output ``s`` of butterfly ``j`` lands at ``(j - k) r + k + s ns``, which
    is the stack of the outputs along a new axis before the last ``ns``."""
    *lead, m = re.shape
    q = m // r
    vr = [re[..., s * q:(s + 1) * q].reshape(*lead, q // ns, ns)
          for s in range(r)]
    vi = [im[..., s * q:(s + 1) * q].reshape(*lead, q // ns, ns)
          for s in range(r)]
    k = torch.arange(ns, device=re.device)
    for s in range(1, r):
        e = s * k * (n // (ns * r))
        wr, wi = tw_re[e], tw_im[e]
        vr[s], vi[s] = vr[s] * wr - vi[s] * wi, vr[s] * wi + vi[s] * wr
    if r == 4:
        t0r, t0i = vr[0] + vr[2], vi[0] + vi[2]
        t1r, t1i = vr[0] - vr[2], vi[0] - vi[2]
        t2r, t2i = vr[1] + vr[3], vi[1] + vi[3]
        dr, di = vr[1] - vr[3], vi[1] - vi[3]  # t3 = -i d
        yr = (t0r + t2r, t1r + di, t0r - t2r, t1r - di)
        yi = (t0i + t2i, t1i - dr, t0i - t2i, t1i + dr)
    else:
        yr = (vr[0] + vr[1], vr[0] - vr[1])
        yi = (vi[0] + vi[1], vi[0] - vi[1])
    return (torch.stack(yr, dim=-2).reshape(*lead, m),
            torch.stack(yi, dim=-2).reshape(*lead, m))


def _fft_planes(padded: torch.Tensor, window: torch.Tensor,
                window_length: int, step: int,
                number_times: int) -> tuple:
    """Re and im planes ``(..., T, N/2+1)`` of the windowed frames' rFFT,
    in the kernel's arithmetic and order, in ``padded``'s dtype."""
    n, m = window_length, window_length // 2
    frames = (extract_frames(padded, n, step, number_times)
              * window.to(padded.dtype))
    tw = twiddles(n, padded.dtype, padded.device)
    tw_re, tw_im = tw[:, 0], tw[:, 1]
    re, im = frames[..., 0::2], frames[..., 1::2]
    ns = 1
    for r in radices(m):
        re, im = _stage(re, im, tw_re, tw_im, n, ns, r)
        ns *= r
    # The split step: X[k] = E + W^k O over k = 0..N/2, Z[N/2] read as Z[0].
    k = torch.arange(m + 1, device=padded.device)
    ia, ib = k % m, (m - k) % m
    ar, ai, br, bi = re[..., ia], im[..., ia], re[..., ib], im[..., ib]
    er, ei = (ar + br) * 0.5, (ai - bi) * 0.5
    od, oi = (ai + bi) * 0.5, (br - ar) * 0.5
    wr, wi = tw_re[:m + 1], tw_im[:m + 1]
    return er + (wr * od - wi * oi), ei + (wr * oi + wi * od)


def frames_rfft_fft_plain(padded: torch.Tensor, window: torch.Tensor,
                          window_length: int, step: int,
                          number_times: int) -> torch.Tensor:
    """Half spectrum ``(..., T, WL/2+1)`` of the windowed frames by the
    kernel's FFT, in plain PyTorch (not ``torch.fft``)."""
    frames_rfft_fft_plain.calls += 1
    return torch.complex(*_fft_planes(padded, window, window_length, step,
                                      number_times))


def frames_matmul2_fft_plain(padded: torch.Tensor, window: torch.Tensor,
                             window_length: int, step: int,
                             number_times: int) -> tuple:
    """:func:`frames_rfft_fft_plain` as ``(re, im)`` float planes."""
    frames_matmul2_fft_plain.calls += 1
    return _fft_planes(padded, window, window_length, step, number_times)


for _fn in (frames_rfft_fft_plain, frames_matmul2_fft_plain):
    _fn.calls = 0


def frames_rfft_fft(padded: torch.Tensor, window: torch.Tensor,
                    window_length: int, step: int,
                    number_times: int) -> torch.Tensor:
    """Windowed-frames real FFT: the ``(..., T, WL/2+1)`` complex half
    spectrum of a padded signal ``(..., L)``, the frames never stored, for
    a power-of-two ``window_length`` in ``[16, 4096]``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not padded.is_cuda:
        return frames_rfft_fft_plain(padded, window, window_length, step,
                                     number_times)
    out = _launch("frames_rfft_fft", False, padded, window, window_length,
                  step, number_times)
    frames_rfft_fft.launches += 1
    return out


def frames_matmul2_fft(padded: torch.Tensor, window: torch.Tensor,
                       window_length: int, step: int,
                       number_times: int) -> tuple:
    """:func:`frames_rfft_fft` as two float32 planes ``(re, im)``, each
    ``(..., T, WL/2+1)``, from one launch: the same values, bit for bit."""
    if not padded.is_cuda:
        return frames_matmul2_fft_plain(padded, window, window_length, step,
                                        number_times)
    out = _launch("frames_matmul2_fft", True, padded, window, window_length,
                  step, number_times)
    frames_matmul2_fft.launches += 1
    return out


def _launch(name: str, planes: bool, padded: torch.Tensor,
            window: torch.Tensor, window_length: int, step: int,
            number_times: int):
    """Check a CUDA input and launch the half (complex) or planes store."""
    check_frame_args(name, padded, window, window_length, step,
                     number_times)
    if not applies(window_length):
        raise ValueError(f"{name}: window_length must be a power of two in "
                         f"[{MIN_WINDOW}, {MAX_WINDOW}], got {window_length}")
    wl, t, f = window_length, number_times, window_length // 2 + 1
    length = padded.shape[-1]
    lead = padded.shape[:-1]
    sig = padded.reshape(-1, length).contiguous()
    batch = sig.shape[0]
    # Frame groups ride grid x (2^31 - 1 blocks), the batch grid y.
    _build.require_grid(batch, 1, name)
    dev = padded.device
    win = window.to(device=dev, dtype=torch.float32).contiguous()
    tw = twiddles(wl, torch.float32, dev)
    if planes:
        out = torch.empty((2, batch, t, f), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((batch, t, f), dtype=torch.complex64, device=dev)
    entry = "zt_rfft_planes" if planes else "zt_rfft_half"
    err = getattr(_build.library(), entry)(
        sig.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(), batch,
        length, t, wl, step, _build.stream_of(padded))
    _build.check(err, entry)
    if planes:
        return out[0].reshape(*lead, t, f), out[1].reshape(*lead, t, f)
    return out.reshape(*lead, t, f)


for _fn in (frames_rfft_fft, frames_matmul2_fft):
    _fn.launches = 0
del _fn
