"""Framing + window + real FFT: the CUDA kernel (``csrc/rfft.cu``) and its
plain version.

It computes what ``zaftpu/pallas/fused.py: _frames_matmul_impl`` computes as
``frames_rfft`` reaches it (B1), ``_frames_matmul2_impl`` (B12) and
``_frames_matmul_full_impl`` (B3): the half spectrum ``X[t, k] = sum_w
sig[t*step + w] * win[w] * exp(-2 pi i k w / N)``, ``k = 0..N/2``, as
interleaved complex (:func:`frames_rfft_fft`), as two float32 planes
(:func:`frames_matmul2_fft`), or as the full spectrum with the conjugate
mirror written by the kernel's store (:func:`frames_rfft_full_fft`), from one
kernel body. The TPU kernels contract each frame with a dense cos/sin
operator; this one runs an FFT, so it is bound by its bytes, not by FP32
arithmetic. The same body's magnitude and mel stores have their wrappers
in :mod:`zaftpu_torch.kernels.melfft`, which checks its inputs with
:func:`device_inputs`.

One shape rule sends every dial here from
:mod:`zaftpu_torch.kernels.fused`: :func:`half_applies`, the half, planes
and full stores' (and the inverse kernel's,
:func:`zaftpu_torch.kernels.irfft.applies`): every window length from
:data:`MIN_WINDOW` to :data:`MAX_WINDOW`, no explicit operator, and
``ZAFTPU_FFT`` not set to ``matmul``. At an even window whose half has no
prime factor above :data:`MAX_PRIME` (:func:`fits`: 1,263 lengths, the
25-ms window at 44.1 kHz, WL 1,102 = 2 * 19 * 29, among them) the static
path runs; at every other window the stores (and the magnitude and mel
stores) run ``rfft_any``, whose layout (:func:`layout`: a complex FFT a
frame at an odd window, Bluestein at :func:`bluestein_length` past a prime
above 127) and tables (:func:`store_tables`) come from here. :func:`applies`
(:func:`fits` on the same two conditions) is left to the paths that need
the static layout: the fast MDCT's quarter, Griffin-Lim's pairing and the
inverse kernel's windowed store. The plain versions repeat the
kernel's arithmetic (the same even/odd packing or zero-imaginary complex
FFT, the same mixed-radix Stockham passes in the same order, the same
twiddle and chirp tables, the same split step), operation by operation, so
the CPU tests exercise the kernel's indexing and the kernel equals them on
the card.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core.frame import extract_frames
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels.framing import check_frame_args

CUDA_SOURCE = "zaftpu_torch/csrc/rfft.cu"
REPLACES = "zaftpu/pallas/fused.py:279"  # _frames_matmul_impl (frames_rfft)
REPLACES_2 = "zaftpu/pallas/fused.py:367"  # _frames_matmul2_impl
REPLACES_FULL = "zaftpu/pallas/fused.py:475"  # _frames_matmul_full_impl
REPLACES_FULL_SPLIT4 = "zaftpu/pallas/fused.py:174"  # _kernel_full_split4

MIN_WINDOW = 16
# The kernels' largest window (zaftpu_torch.kernels.MAX_WINDOW; above it the
# framing kernel and the FFT layer): the direct DFT GEMM's default bound,
# and this kernel's 2,048 complex values per block.
MAX_WINDOW = 4096
# The largest prime factor of N/2 that a pass takes (csrc/stockham.cuh:
# kMaxPrime). A direct p-point butterfly sums (p - 1)/2 terms an output: up
# to 63 here, where a lone prime of 2,039 (WL 4,078) would sum 1,019.
MAX_PRIME = 127


def _factors(m: int) -> tuple:
    """The prime factors of ``m`` up to :data:`MAX_PRIME`, ascending with
    repeats, and what is left of ``m`` after them (1 when there is none
    above)."""
    out = []
    for p in range(2, MAX_PRIME + 1):
        while m % p == 0:
            m //= p
            out.append(p)
    return out, m


def fits(window_length: int) -> bool:
    """Does the kernel take this window length? An even ``N`` in
    ``[MIN_WINDOW, MAX_WINDOW]`` whose half ``N/2`` has no prime factor
    above :data:`MAX_PRIME`: 1,263 lengths. The CUDA entry accepts exactly
    this set."""
    n = int(window_length)
    if n % 2 or not MIN_WINDOW <= n <= MAX_WINDOW:
        return False
    return _factors(n // 2)[1] == 1


def _engine_allows(ops) -> bool:
    """No explicit operator (an explicit ``ops`` names the GEMM kernels) and
    ``ZAFTPU_FFT`` not ``matmul``.

    ``ZAFTPU_FFT`` is ``zaftpu``'s FFT-engine lever with its meaning
    (zaftpu/core/fft.py: engine_selected): ``matmul`` runs the DFT as a
    GEMM everywhere, so here it turns the rules off and the GEMM kernels
    (their split4 twins under split4) take every window; ``auto`` (the
    default) and ``native`` follow the rules."""
    return ops is None and os.environ.get("ZAFTPU_FFT", "auto") != "matmul"


def applies(window_length: int, ops=None) -> bool:
    """The static path's rule (the fast MDCT's quarter, Griffin-Lim's
    pairing): the window length :func:`fits`, no operator is given, and
    ``ZAFTPU_FFT`` is not ``matmul``."""
    return _engine_allows(ops) and fits(window_length)


def half_applies(window_length: int, ops=None) -> bool:
    """The half, planes and full stores' shape rule (and the inverse
    kernel's): any window length from :data:`MIN_WINDOW` to
    :data:`MAX_WINDOW` (``rfft_any`` where :func:`fits` refuses it), no
    operator given, and ``ZAFTPU_FFT`` not ``matmul``, as
    :func:`zaftpu_torch.kernels.melfft.applies` for the magnitude and mel
    stores."""
    return (_engine_allows(ops)
            and MIN_WINDOW <= int(window_length) <= MAX_WINDOW)


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
    """The Stockham passes of an ``m``-point complex FFT, ``m`` free of
    prime factors above :data:`MAX_PRIME`: radix 4 while it fits in the
    power-of-two part, one radix-2 pass when that part's log2 is odd, then
    the 3s, 5s and 7s, then each prime above 7, ascending (at most three
    for ``m <= 2048``). A 7-smooth ``m`` keeps the plan it had before the
    primes above 7."""
    plan, rest = _factors(m)
    if rest != 1:
        raise ValueError(f"radices: {m} has a prime factor above "
                         f"{MAX_PRIME}")
    twos = plan.count(2)
    return (4,) * (twos // 2) + (2,) * (twos % 2) + tuple(plan[twos:])


# The magnitude and mel stores off the rule (csrc/rfft.cu: rfft_any) run
# in a block of 2,048, 4,096 or 8,192 complex values: the static block's
# size, then two of dynamic shared memory.
BLOCKS = (2048, 4096, 8192)


@lru_cache(maxsize=1)
def _smooth_lengths() -> np.ndarray:
    """Every length from 1 to ``BLOCKS[-1]`` with no prime factor above
    :data:`MAX_PRIME`, ascending (a largest-prime-factor sieve)."""
    top = BLOCKS[-1]
    largest = np.zeros(top + 1, np.int64)
    for p in range(2, top + 1):
        if largest[p] == 0:  # p is prime
            largest[p::p] = p
    return np.flatnonzero(largest[1:] <= MAX_PRIME) + 1


@lru_cache(maxsize=None)
def pass_ops(m: int) -> int:
    """Operations of the passes of an ``m``-point complex FFT in the plan
    of :func:`radices`: each input of a butterfly past the first times its
    twiddle (6), then the butterfly: 4 (radix 2), 16 (radix 4), or for an
    odd radix ``r`` with ``h = (r - 1)/2`` the ``4h`` sums and differences,
    ``2h`` adds for ``y_0`` and ``8h + 2`` for each of the ``h`` other
    output pairs."""
    total = 0
    for r in radices(m):
        h = (r - 1) // 2
        fly = {2: 4, 4: 16}.get(r, 6 * h + h * (8 * h + 2))
        total += m // r * (6 * (r - 1) + fly)
    return total


@lru_cache(maxsize=64)
def bluestein_length(m: int) -> int:
    """The length ``P`` of the circular convolution that gives an
    ``m``-point DFT by Bluestein's chirp z-transform: ``P >= 2m - 1`` with
    no prime factor above :data:`MAX_PRIME`, so the passes take it. Of
    those up to the smallest of :data:`BLOCKS` that holds ``2m - 1``, the
    one with the fewest operations for the two ``P``-point FFTs and the
    table product, ``2 pass_ops(P) + 6 P`` (the shorter on a tie): the
    smallest such ``P`` can hold a large prime, which a pass pays ``O(p)``
    operations a point for (``m`` 131: 261 = 3^2 * 29 costs 1.8 times 288
    = 2^5 * 3^2; ``m`` 1,031: 2,064 = 2^4 * 3 * 43 costs twice 2,304 =
    2^8 * 3^2; ``m`` 2,039: 4,080 = 2^4 * 3 * 5 * 17 costs 1.5 times
    4,096)."""
    low = 2 * m - 1
    cap = next(b for b in BLOCKS if b >= low)
    lengths = _smooth_lengths()
    lengths = lengths[(lengths >= low) & (lengths <= cap)]
    return min((int(p) for p in lengths),
               key=lambda p: (2 * pass_ops(p) + 6 * p, p))


class Layout(NamedTuple):
    """How the magnitude and mel stores transform a frame of ``N``
    samples: ``odd`` takes the frame as the real parts of one complex
    ``N``-point FFT (``N`` odd), else its even and odd samples as one
    ``N/2``-point FFT; ``m`` is that FFT's length and ``p`` the length of
    its Bluestein convolution, 0 when the passes take ``m`` itself."""

    odd: bool
    m: int
    p: int


def layout(n: int) -> Layout:
    odd = n % 2 == 1
    m = n if odd else n // 2
    return Layout(odd, m, 0 if _factors(m)[1] == 1 else bluestein_length(m))


@lru_cache(maxsize=8)
def _store_tables(n: int, rdtype_name: str = "float32") -> np.ndarray:
    """``(rows, 2)`` tables of the magnitude and mel stores at window ``n``:
    :func:`_twiddles` of ``n``, and under Bluestein (``layout(n).p``) after
    it the twiddles of ``P``, the chirp ``conj c[j] = exp(-i pi (j^2 mod
    2m) / m)`` for ``j < m`` (``j^2`` reduced in integers) and ``B =
    FFT_P(b) / P`` with ``b[j] = c[|j|]`` wrapped modulo ``P`` (zero for
    ``m <= j <= P - m``): float64 math rounded once to the target dtype."""
    lay = layout(n)
    parts = [_twiddles(n, "float64")]
    if lay.p:
        m, p = lay.m, lay.p
        j = np.arange(m, dtype=np.int64)
        c = np.exp(1j * np.pi * ((j * j) % (2 * m)) / m)
        b = np.zeros(p, np.complex128)
        b[:m] = c
        b[p - m + 1:] = c[:0:-1]
        big = np.fft.fft(b) / p
        parts += [_twiddles(p, "float64"), np.stack([c.real, -c.imag], -1),
                  np.stack([big.real, big.imag], -1)]
    return np.concatenate(parts).astype(rdtype_name)


def store_tables(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    return _fft.device_operator(_store_tables, (n, _fft._real_name(dtype)),
                                torch.device(device), dtype)


@lru_cache(maxsize=16)
def _pass_tables(m: int, n: int) -> np.ndarray:
    """The per-pass twiddle tables of an ``m``-point FFT on the twiddle
    table of ``W_n`` (``m`` divides ``n``): for each pass of
    :func:`radices` of ``m``, radix ``r`` entered at sub-transform length
    ``ns``, the ``(r - 1) * ns`` entries ``W_n^(s k n/(ns r))`` at ``(s -
    1) ns + k`` (``s = 1..r-1``, ``k < ns``), passes in order: a gather
    from :func:`_twiddles` of ``n``, no new rounding (``csrc/stockham.cuh``:
    ``steps_plan`` reads them there)."""
    tw = _twiddles(n)
    parts, ns = [], 1
    for r in radices(m):
        s = np.arange(1, r)[:, None]
        k = np.arange(ns)[None, :]
        parts.append(tw[(s * k * (n // (ns * r))).reshape(-1)])
        ns *= r
    return np.concatenate(parts)


@lru_cache(maxsize=8)
def _kernel_tables(n: int) -> np.ndarray:
    """The table the C entries of the stores and the inverse take at window
    ``n``: where it :func:`fits`, :func:`_twiddles` then the pass tables of
    the ``N/2``-point FFT on ``W_N``; elsewhere :func:`_store_tables` then
    the pass tables of the ``L``-point FFT on ``W_L``, ``L`` the FFT's own
    length or its Bluestein length (:func:`layout`: ``rfft_any`` and
    ``irfft_any``)."""
    if not fits(n):
        lay = layout(n)
        length = lay.p or lay.m
        return np.concatenate([_store_tables(n),
                               _pass_tables(length, length)])
    return np.concatenate([_twiddles(n), _pass_tables(n // 2, n)])


def kernel_tables(n: int, device) -> torch.Tensor:
    return _fft.device_operator(_kernel_tables, (n,), torch.device(device),
                                torch.float32)


def divmod_multiplier(d: int) -> int:
    """The static path's multiplier for a division by ``d`` (``csrc/
    stockham.cuh``: ``make_divmod``): ``x // d == (x * mul) >> 32`` for
    ``0 <= x`` and ``x * d < 2**32``, ``mul = 2**32 // d + 1``; 0 for ``d
    = 1`` (the quotient is ``x``)."""
    return 0 if d == 1 else 2 ** 32 // d + 1


def _odd_butterfly(vr, vi, c, s):
    """The direct ``r``-point DFT of ``r`` odd inputs, ``r = len(vr)``:
    with ``a_p = v_p + v_{r-p}``, ``b_p = v_p - v_{r-p}`` (``p = 1..h``,
    ``h = (r-1)/2``), ``y_0 = v_0 + a_1 + ... + a_h`` and, for ``t = 1..h``,
    ``A = v_0 + sum_p a_p cos(2 pi p t / r)``, ``B = sum_p b_p sin(2 pi p t
    / r)``, ``y_t = A - i B``, ``y_{r-t} = A + i B``; sums left to right.
    ``c[k]``, ``s[k]`` are cos and sin of ``2 pi k / r``."""
    r = len(vr)
    h = (r - 1) // 2
    ar = [None] + [vr[p] + vr[r - p] for p in range(1, h + 1)]
    ai = [None] + [vi[p] + vi[r - p] for p in range(1, h + 1)]
    br = [None] + [vr[p] - vr[r - p] for p in range(1, h + 1)]
    bi = [None] + [vi[p] - vi[r - p] for p in range(1, h + 1)]
    yr, yi = [vr[0]] + [None] * (r - 1), [vi[0]] + [None] * (r - 1)
    for p in range(1, h + 1):
        yr[0], yi[0] = yr[0] + ar[p], yi[0] + ai[p]
    for t in range(1, h + 1):
        sa_r, sa_i = vr[0], vi[0]
        sb_r, sb_i = br[1] * s[t], bi[1] * s[t]
        for p in range(1, h + 1):
            k = p * t % r
            sa_r, sa_i = sa_r + ar[p] * c[k], sa_i + ai[p] * c[k]
            if p > 1:
                sb_r, sb_i = sb_r + br[p] * s[k], sb_i + bi[p] * s[k]
        yr[t], yi[t] = sa_r + sb_i, sa_i - sb_r
        yr[r - t], yi[r - t] = sa_r - sb_i, sa_i + sb_r
    return yr, yi


def _stage(re, im, tw_re, tw_im, n, ns, r):
    """One radix-``r`` Stockham pass over the last axis (``m`` = N/2 points,
    sub-transforms of length ``ns`` growing to ``ns * r``): ``csrc/rfft.cu``
    ``stage``, vectorised. Input ``s`` is the slice ``[s q, (s+1) q)``;
    output ``s`` of butterfly ``j`` lands at ``(j - k) r + k + s ns``, which
    is the stack of the outputs along a new axis before the last ``ns``.
    An odd ``r`` takes its constants from the twiddle table:
    ``W_N^(k N/r) = (cos, -sin)(2 pi k / r)``. A prime above 7 in the first
    pass (``ns = 1``) skips the twiddle products, which are all by ``W^0 =
    1``, as the kernel's odd-prime pass does."""
    *lead, m = re.shape
    q = m // r
    vr = [re[..., s * q:(s + 1) * q].reshape(*lead, q // ns, ns)
          for s in range(r)]
    vi = [im[..., s * q:(s + 1) * q].reshape(*lead, q // ns, ns)
          for s in range(r)]
    k = torch.arange(ns, device=re.device)
    if r <= 7 or ns > 1:
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
    elif r == 2:
        yr = (vr[0] + vr[1], vr[0] - vr[1])
        yi = (vi[0] + vi[1], vi[0] - vi[1])
    else:
        idx = [j * (n // r) for j in range(r)]
        yr, yi = _odd_butterfly(vr, vi, [tw_re[j] for j in idx],
                                [-tw_im[j] for j in idx])
    return (torch.stack(yr, dim=-2).reshape(*lead, m),
            torch.stack(yi, dim=-2).reshape(*lead, m))


def fft_rows_plain(re: torch.Tensor, im: torch.Tensor, tw: torch.Tensor,
                   n: int) -> tuple:
    """The complex FFT of rows ``(..., m)`` (re and im planes) by the
    Stockham passes of :func:`radices` (``m``) with the ``(n, 2)`` twiddle
    table of ``W_n``, ``m`` dividing ``n``: the passes of
    ``csrc/stockham.cuh``'s steps, operation by operation."""
    tw_re, tw_im = tw[:, 0], tw[:, 1]
    ns = 1
    for r in radices(re.shape[-1]):
        re, im = _stage(re, im, tw_re, tw_im, n, ns, r)
        ns *= r
    return re, im


def split_planes(re: torch.Tensor, im: torch.Tensor, tw: torch.Tensor,
                 m: int) -> tuple:
    """The split step of the real FFT of N = 2m samples from the FFT ``Z``
    of their even/odd packing (the first ``m`` values of each row): ``X[k]
    = E + W_N^k O`` over ``k = 0..m``, ``Z[m]`` read as ``Z[0]``, ``tw``
    the table of ``W_N`` (``csrc/rfft.cu``: ``split_pair``)."""
    k = torch.arange(m + 1, device=re.device)
    ia, ib = k % m, (m - k) % m
    ar, ai, br, bi = re[..., ia], im[..., ia], re[..., ib], im[..., ib]
    er, ei = (ar + br) * 0.5, (ai - bi) * 0.5
    od, oi = (ai + bi) * 0.5, (br - ar) * 0.5
    wr, wi = tw[:m + 1, 0], tw[:m + 1, 1]
    return er + (wr * od - wi * oi), ei + (wr * oi + wi * od)


def frames_fft_planes(frames: torch.Tensor, n: int,
                      tw: torch.Tensor | None = None) -> tuple:
    """Re and im planes ``(..., N/2+1)`` of the rFFT of real rows ``(...,
    N)`` in the kernel's arithmetic and order: the even/odd packing, the
    Stockham passes of :func:`radices` with the twiddle table of ``N`` (or
    ``tw``, another ``(N, 2)`` table of ``W_N^j``), the split step."""
    if tw is None:
        tw = twiddles(n, frames.dtype, frames.device)
    re, im = fft_rows_plain(frames[..., 0::2], frames[..., 1::2], tw, n)
    return split_planes(re, im, tw, n // 2)


def bluestein_plain(re: torch.Tensor, im: torch.Tensor, lay: Layout,
                    tables: torch.Tensor) -> tuple:
    """The ``m``-point FFT of rows ``(..., m)`` by Bluestein's chirp
    z-transform on the passes, in ``rfft_any``'s order: times the chirp,
    zero-padded to ``P``, the forward passes, times the table ``B``,
    conjugated, the forward passes again, conjugated, times the chirp.
    ``tables`` is :func:`store_tables` of the window."""
    m, p = lay.m, lay.p
    n = tables.shape[0] - 2 * p - m
    tw_p, chirp, big = tables[n:].split([p, m, p])
    cr, ci = chirp[:, 0], chirp[:, 1]
    pad = (0, p - m)
    ar = torch.nn.functional.pad(re * cr - im * ci, pad)
    ai = torch.nn.functional.pad(re * ci + im * cr, pad)
    ar, ai = fft_rows_plain(ar, ai, tw_p, p)
    br, bi = big[:, 0], big[:, 1]
    yr, yi = fft_rows_plain(ar * br - ai * bi, -(ar * bi + ai * br), tw_p, p)
    yr, yi = yr[..., :m], -yi[..., :m]
    return yr * cr - yi * ci, yr * ci + yi * cr


def _any_planes(padded: torch.Tensor, window: torch.Tensor,
                window_length: int, step: int, number_times: int) -> tuple:
    """Re and im planes ``(..., T, WL//2+1)`` of bins ``0..WL//2`` of the
    windowed frames' DFT in ``rfft_any``'s arithmetic and order, at any
    window: an odd one's frames each the real parts of one complex
    ``N``-point FFT (its first ``(N+1)/2`` bins), an even one's even/odd
    packing and the split step; an FFT length with a prime factor above
    :data:`MAX_PRIME` by :func:`bluestein_plain`."""
    wl = window_length
    lay = layout(wl)
    tables = store_tables(wl, padded.dtype, padded.device)
    frames = (extract_frames(padded, wl, step, number_times)
              * window.to(padded.dtype))
    if lay.odd:
        re, im = frames, torch.zeros_like(frames)
    else:
        re, im = frames[..., 0::2], frames[..., 1::2]
    if lay.p:
        re, im = bluestein_plain(re, im, lay, tables)
    else:
        re, im = fft_rows_plain(re, im, tables, wl)
    if lay.odd:
        return re[..., :wl // 2 + 1], im[..., :wl // 2 + 1]
    return split_planes(re, im, tables, lay.m)


def half_planes(padded: torch.Tensor, window: torch.Tensor,
                window_length: int, step: int, number_times: int) -> tuple:
    """Re and im planes ``(..., T, WL//2+1)`` of the half spectrum in the
    arithmetic of the kernel the half and planes stores launch at
    ``window_length``, in ``padded``'s dtype: ``rfft_kernel``'s where it
    :func:`fits`, else ``rfft_any``'s. The full, magnitude and mel stores'
    plain versions take their bins from here."""
    if not fits(window_length):
        return _any_planes(padded, window, window_length, step, number_times)
    frames = (extract_frames(padded, window_length, step, number_times)
              * window.to(padded.dtype))
    return frames_fft_planes(frames, window_length)


def frames_rfft_fft_plain(padded: torch.Tensor, window: torch.Tensor,
                          window_length: int, step: int,
                          number_times: int) -> torch.Tensor:
    """Half spectrum ``(..., T, WL//2+1)`` of the windowed frames by the
    kernel's FFT (:func:`half_planes`), in plain PyTorch (not
    ``torch.fft``)."""
    frames_rfft_fft_plain.calls += 1
    return torch.complex(*half_planes(padded, window, window_length, step,
                                      number_times))


def frames_matmul2_fft_plain(padded: torch.Tensor, window: torch.Tensor,
                             window_length: int, step: int,
                             number_times: int) -> tuple:
    """:func:`frames_rfft_fft_plain` as ``(re, im)`` float planes."""
    frames_matmul2_fft_plain.calls += 1
    return half_planes(padded, window, window_length, step, number_times)


def frames_rfft_full_fft_plain(padded: torch.Tensor, window: torch.Tensor,
                               window_length: int, step: int,
                               number_times: int) -> torch.Tensor:
    """Full spectrum ``(..., T, WL)``: :func:`frames_rfft_fft_plain`'s half
    spectrum and the conjugate mirror's index gathers."""
    frames_rfft_full_fft_plain.calls += 1
    half = torch.complex(*half_planes(padded, window, window_length, step,
                                      number_times))
    return _fft.conjugate_mirror(half, window_length)


for _fn in (frames_rfft_fft_plain, frames_matmul2_fft_plain,
            frames_rfft_full_fft_plain):
    _fn.calls = 0


def frames_rfft_fft(padded: torch.Tensor, window: torch.Tensor,
                    window_length: int, step: int,
                    number_times: int) -> torch.Tensor:
    """Windowed-frames real FFT: the ``(..., T, WL//2+1)`` complex half
    spectrum of a padded signal ``(..., L)``, the frames never stored, for
    any ``window_length`` from :data:`MIN_WINDOW` to :data:`MAX_WINDOW`
    (``rfft_any`` where it does not :func:`fits`; bins ``0..(WL-1)/2`` at
    an odd one).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not padded.is_cuda:
        return frames_rfft_fft_plain(padded, window, window_length, step,
                                     number_times)
    out, launched = _launch("frames_rfft_fft", "half", padded, window,
                            window_length, step, number_times)
    frames_rfft_fft.launches += launched
    return out


def frames_matmul2_fft(padded: torch.Tensor, window: torch.Tensor,
                       window_length: int, step: int,
                       number_times: int) -> tuple:
    """:func:`frames_rfft_fft` as two float32 planes ``(re, im)``, each
    ``(..., T, WL//2+1)``, from one launch: the same values, bit for bit,
    at every window it takes."""
    if not padded.is_cuda:
        return frames_matmul2_fft_plain(padded, window, window_length, step,
                                        number_times)
    out, launched = _launch("frames_matmul2_fft", "planes", padded, window,
                            window_length, step, number_times)
    frames_matmul2_fft.launches += launched
    return out


def frames_rfft_full_fft(padded: torch.Tensor, window: torch.Tensor,
                         window_length: int, step: int,
                         number_times: int) -> torch.Tensor:
    """:func:`frames_rfft_fft` as the ``(..., T, WL)`` full spectrum, the
    reference's zaf.py:139 convention: bin ``WL - k`` the conjugate of bin
    ``k`` (``k = 1..(WL-1)//2``), written by the kernel's store in the same
    launch, at any window :func:`frames_rfft_fft` takes. Bit-equal to
    :func:`frames_rfft_fft` followed by
    :func:`zaftpu_torch.core.fft.conjugate_mirror`.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not padded.is_cuda:
        return frames_rfft_full_fft_plain(padded, window, window_length,
                                          step, number_times)
    out, launched = _launch("frames_rfft_full_fft", "full", padded, window,
                            window_length, step, number_times)
    frames_rfft_full_fft.launches += launched
    return out


def device_inputs(name: str, padded: torch.Tensor, window: torch.Tensor,
                  window_length: int, step: int, number_times: int) -> tuple:
    """Check a CUDA input for the kernel's C entries ``zt_rfft_*`` (any
    window length from :data:`MIN_WINDOW` to :data:`MAX_WINDOW`); return the
    signal as ``(batch, L)``, the float32 window and :func:`kernel_tables`
    on its device, and the leading axes."""
    check_frame_args(name, padded, window, window_length, step,
                     number_times)
    if not MIN_WINDOW <= window_length <= MAX_WINDOW:
        raise ValueError(f"{name}: window_length must be in "
                         f"[{MIN_WINDOW}, {MAX_WINDOW}], got "
                         f"{window_length}")
    sig = padded.reshape(-1, padded.shape[-1]).contiguous()
    # Frame groups ride grid x (2^31 - 1 blocks), the batch grid y.
    _build.require_grid(sig.shape[0], 1, name)
    dev = padded.device
    win = window.to(device=dev, dtype=torch.float32).contiguous()
    return sig, win, kernel_tables(window_length, dev), padded.shape[:-1]


def _launch(name: str, store: str, padded: torch.Tensor,
            window: torch.Tensor, window_length: int, step: int,
            number_times: int) -> tuple:
    """Check a CUDA input and launch one store, the C entry
    ``zt_rfft_<store>``: ``half`` (complex), ``planes`` (two float32
    planes) or ``full`` (complex, mirrored) at any window from
    :data:`MIN_WINDOW` to :data:`MAX_WINDOW` (the Bluestein length after
    the hop). Returns the output and whether it launched (not for zero
    frames or rows)."""
    wl, t = window_length, number_times
    sig, win, tw, lead = device_inputs(name, padded, window, wl, step, t)
    entry = f"zt_rfft_{store}"
    f = wl if store == "full" else wl // 2 + 1
    batch, length = sig.shape
    dev = padded.device
    if store == "planes":
        out = torch.empty((2, batch, t, f), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((batch, t, f), dtype=torch.complex64, device=dev)
    if out.numel():
        err = getattr(_build.library(), entry)(
            sig.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(),
            batch, length, t, wl, step, layout(wl).p,
            _build.stream_of(padded))
        _build.check(err, entry)
    if store == "planes":
        return ((out[0].reshape(*lead, t, f), out[1].reshape(*lead, t, f)),
                bool(out.numel()))
    return out.reshape(*lead, t, f), bool(out.numel())


for _fn in (frames_rfft_fft, frames_matmul2_fft, frames_rfft_full_fft):
    _fn.launches = 0
del _fn
