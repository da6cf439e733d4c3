"""MDCT analysis and IMDCT synthesis by a quarter-length complex FFT: the
CUDA kernels (``csrc/mdct.cu``) and their plain versions.

:func:`mdct_fft` computes what ``zaftpu/pallas/fused.py:
_frames_matmul_impl`` computes as ``frames_op`` reaches it with the MDCT
operator (B2) and its ``_kernel_split4`` (B2-s4): with ``N`` the window
length, ``F = N/2`` and ``n0 = (F + 1)/2``,
``X[t, k] = sum_{n<N} w[n] x[t F + n] cos(2 pi/N (n + n0)(k + 1/2))``,
``k < F``, frames-major ``(..., T, F)`` (reference zaf.py:1036-1071).
:func:`imdct_ola_fft` computes what ``zaftpu/pallas/synth.py:
_gemm_ola_impl`` computes as ``imdct_ola`` reaches it (B7) and its
``_kernel_split4`` (B7-s4): each frame's ``y_t[n] = (2/F) w[n] sum_{k<F}
X[t, k] cos(2 pi/N (n + n0)(k + 1/2))`` overlap-added at hop ``F``, the
``(..., T F + F)`` signal before the reference's trim (zaf.py:1138-1182).
The TPU kernels contract each frame with a dense ``(N, F)`` operator; these
run the standard fast MDCT with ``Q = N/4``:

* forward: fold the windowed frame into the DCT-IV input ``v`` (``v[j] =
  -(u[3Q-1-j] + u[3Q+j])``, ``v[Q+j] = u[j] - u[2Q-1-j]``, ``j < Q``), pack
  ``z[n] = v[2n] + i v[F-1-2n]``, multiply by the pre-twiddle ``exp(-i pi
  n / F)``, run a ``Q``-point complex FFT, multiply by the post-twiddle
  ``exp(-i pi (k + 1/4) / F)`` and read ``X[2k] = Re``, ``X[F-1-2k] =
  -Im``;
* inverse: the same DCT-IV of the coefficients, unfolded to ``N`` samples
  by the TDAC symmetries (``y[j] = d[Q+j]``, ``y[Q+j] = -d[2Q-1-j]``,
  ``y[2Q+j] = -d[Q-1-j]``, ``y[3Q+j] = -d[j]``), times the window scaled by
  ``2/F`` (one float32 table, rounded once from float64), overlap-added
  frame by frame as ``imdct_ola`` sums them.

The ``Q``-point FFT is the static real FFT's at window ``N/2``: the
register steps the real-FFT kernels share (``csrc/stockham.cuh``:
``fft_steps``) on :mod:`zaftpu_torch.kernels.rfft`'s plan and tables
(``kernel_tables(N/2)``, whose first ``N/2`` rows are the twiddle table
``_stage`` reads here), so :func:`fits` is ``N % 4 == 0`` and the real-FFT
rule at ``N/2``, up to :data:`MAX_WINDOW`: 724 window lengths, 256, 512,
1,024, 1,920, 2,048 and 4,096 among them. :func:`applies` adds "no
explicit operator" and ``ZAFTPU_FFT`` not ``matmul``, as
:func:`zaftpu_torch.kernels.rfft.applies` does. The plain versions repeat
the kernels' float32 operations in their order (the fold, the tables, the
passes, the overlap-add), so the CPU tests exercise the kernels' indexing
and the kernels equal them on the card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core.frame import extract_frames, overlap_add
from zaftpu_torch.kernels import _build
from zaftpu_torch.kernels import rfft as _rfft
from zaftpu_torch.kernels.framing import check_frame_args

CUDA_SOURCE = "zaftpu_torch/csrc/mdct.cu"
REPLACES = "zaftpu/pallas/fused.py:590"  # frames_op (B2)
REPLACES_IMDCT = "zaftpu/pallas/synth.py:408"  # imdct_ola (B7)

# The kernels' largest window (zaftpu_torch.kernels.MAX_WINDOW).
MAX_WINDOW = _rfft.MAX_WINDOW


def fits(window_length: int) -> bool:
    """Do the kernels take this window length? ``N`` a multiple of 4 up to
    :data:`MAX_WINDOW` whose half the real-FFT kernel takes
    (:func:`zaftpu_torch.kernels.rfft.fits`): ``N`` from 32, ``N/4`` free of
    prime factors above :data:`zaftpu_torch.kernels.rfft.MAX_PRIME`. The
    CUDA entries accept exactly this set."""
    n = int(window_length)
    return n % 4 == 0 and n <= MAX_WINDOW and _rfft.fits(n // 2)


def applies(window_length: int, ops=None) -> bool:
    """The shape rule: the FFT kernels compute the MDCT (IMDCT) when the
    window length :func:`fits` and the real-FFT rule at its half applies
    (:func:`zaftpu_torch.kernels.rfft.applies`): no operator is given (an
    explicit ``ops`` names the GEMM kernels) and ``ZAFTPU_FFT`` is not
    ``matmul``, ``zaftpu``'s FFT-engine lever, which sends every window to
    the GEMMs (their split4 twins under split4)."""
    return fits(window_length) and _rfft.applies(window_length // 2, ops)


@lru_cache(maxsize=8)
def _twiddles(n: int, rdtype_name: str = "float32") -> np.ndarray:
    """``(2, N/4, 2)``: the pre-twiddle ``exp(-i pi j / F)`` (``zaftpu``'s
    forward pre-twiddle ``exp(-i pi m / N)`` at ``m = 2j``) and the
    post-twiddle ``exp(-i pi (j + 1/4) / F)``, ``j < N/4``, as (cos, sin):
    float64 math rounded once to the target dtype."""
    j = np.arange(n // 4)
    tw = np.exp(-1j * np.pi / n * np.stack([2 * j, 2 * j + 0.5]))
    return np.stack([tw.real, tw.imag], axis=-1).astype(rdtype_name)


def twiddles(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    return _fft.device_operator(_twiddles, (n, _fft._real_name(dtype)),
                                torch.device(device), dtype)


@lru_cache(maxsize=8)
def _synthesis_window(window_bytes: bytes,
                      rdtype_name: str = "float32") -> np.ndarray:
    """The TDAC window times the inverse's ``2/F``, float64 math rounded
    once to the target dtype; ``window_bytes`` are the float64 window's
    bytes, which key its device copy as they key ``imdct_ola``'s
    operator."""
    win = np.frombuffer(window_bytes, dtype=np.float64)
    return (win * (4.0 / win.shape[0])).astype(rdtype_name)


def synthesis_window(window_bytes: bytes, dtype: torch.dtype,
                     device) -> torch.Tensor:
    return _fft.device_operator(_synthesis_window,
                                (window_bytes, _fft._real_name(dtype)),
                                torch.device(device), dtype)


def _dct4(re: torch.Tensor, im: torch.Tensor, n: int) -> torch.Tensor:
    """The DCT-IV ``(..., F)`` of the packed pairs ``re + i im`` ``(...,
    N/4)`` (``v[2j] + i v[F-1-2j]``) in the kernels' arithmetic and order:
    the pre-twiddle, the ``N/4``-point Stockham passes, the post-twiddle,
    then ``d[2k] = Re``, ``d[F-1-2k] = -Im``."""
    q = n // 4
    tw = twiddles(n, re.dtype, re.device)
    pc, ps, qc, qs = tw[0, :, 0], tw[0, :, 1], tw[1, :, 0], tw[1, :, 1]
    re, im = re * pc - im * ps, re * ps + im * pc
    ftw = _rfft.twiddles(2 * q, re.dtype, re.device)
    ns = 1
    for r in _rfft.radices(q):
        re, im = _rfft._stage(re, im, ftw[:, 0], ftw[:, 1], 2 * q, ns, r)
        ns *= r
    yr, yi = re * qc - im * qs, re * qs + im * qc
    return torch.stack((yr, (-yi).flip(-1)), dim=-1).flatten(-2)


def mdct_fft_plain(padded: torch.Tensor, window: torch.Tensor,
                   window_length: int, number_times: int) -> torch.Tensor:
    """MDCT coefficients ``(..., T, N/2)`` of the windowed frames at hop
    ``N/2`` by the kernel's fold and FFT, in plain PyTorch (not
    ``torch.fft``)."""
    mdct_fft_plain.calls += 1
    n, q = window_length, window_length // 4
    u = (extract_frames(padded, n, n // 2, number_times)
         * window.to(padded.dtype))
    a, b, c, d = (u[..., i * q:(i + 1) * q] for i in range(4))
    v = torch.cat((-(c.flip(-1) + d), a - b.flip(-1)), dim=-1)
    return _dct4(v[..., 0::2], v.flip(-1)[..., 0::2], n)


def imdct_ola_fft_plain(coeffs: torch.Tensor, f: int,
                        window_bytes: bytes) -> torch.Tensor:
    """The inverse kernel's function in plain PyTorch (not ``torch.fft``):
    the ``(..., T F + F)`` overlap-add at hop ``F`` of each frame's DCT-IV,
    unfolded to ``2F`` samples and times the window scaled by ``2/F``."""
    imdct_ola_fft_plain.calls += 1
    n, q = 2 * f, f // 2
    d = _dct4(coeffs[..., 0::2], coeffs.flip(-1)[..., 0::2], n)
    lo, hi = d[..., :q], d[..., q:]
    y = torch.cat((hi, -hi.flip(-1), -lo.flip(-1), -lo), dim=-1)
    win = synthesis_window(window_bytes, coeffs.dtype, coeffs.device)
    return overlap_add(y * win, f)


mdct_fft_plain.calls = 0
imdct_ola_fft_plain.calls = 0


def mdct_fft(padded: torch.Tensor, window: torch.Tensor, window_length: int,
             number_times: int) -> torch.Tensor:
    """MDCT analysis by the quarter-length FFT: the ``(..., T, N/2)``
    coefficients of a padded signal ``(..., L)``, ``L >= (T + 1) N/2``,
    frames at hop ``N/2``, never stored, for an ``N`` that :func:`fits`.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not padded.is_cuda:
        return mdct_fft_plain(padded, window, window_length, number_times)
    return _mdct_fft_cuda(padded, window, window_length, number_times)


def _mdct_fft_cuda(padded: torch.Tensor, window: torch.Tensor,
                   window_length: int, number_times: int) -> torch.Tensor:
    """Check the CUDA input, launch the kernel, count the launch."""
    name = "mdct_fft"
    n, t = window_length, number_times
    check_frame_args(name, padded, window, n, n // 2, t)
    _check_fits(name, n)
    length = padded.shape[-1]
    lead = padded.shape[:-1]
    sig = padded.reshape(-1, length).contiguous()
    batch = sig.shape[0]
    _build.require_grid(batch, 1, name)
    dev = padded.device
    win = window.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((batch, t, n // 2), dtype=torch.float32, device=dev)
    if t and batch:
        err = _build.library().zt_mdct_fft(
            sig.data_ptr(), win.data_ptr(),
            twiddles(n, torch.float32, dev).data_ptr(),
            _rfft.kernel_tables(n // 2, dev).data_ptr(),
            out.data_ptr(), batch, length, t, n, _build.stream_of(padded))
        _build.check(err, "zt_mdct_fft")
        mdct_fft.launches += 1
    return out.reshape(*lead, t, n // 2)


def imdct_ola_fft(coeffs: torch.Tensor, f: int,
                  window_bytes: bytes) -> torch.Tensor:
    """IMDCT synthesis by the quarter-length FFT: the ``(..., T F + F)``
    TDAC overlap-add, before the reference's trim, of the frames-major
    coefficients ``(..., T, F)`` for a window of ``2F`` samples that
    :func:`fits`; ``window_bytes`` are the float64 window's bytes.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises. At ``T = 0`` both
    return ``F`` zeros.
    """
    if not coeffs.is_cuda:
        return imdct_ola_fft_plain(coeffs, f, window_bytes)
    return _imdct_ola_fft_cuda(coeffs, f, window_bytes)


def _imdct_ola_fft_cuda(coeffs: torch.Tensor, f: int,
                        window_bytes: bytes) -> torch.Tensor:
    """Check the CUDA input, launch the kernel and count the launch, or
    with no frames (or no rows) return the ``F`` zeros a row without one."""
    name = "imdct_ola_fft"
    _build.require_f32(coeffs, name)
    n = 2 * f
    _check_fits(name, n)
    *lead, t, width = coeffs.shape
    if width != f:
        raise ValueError(f"{name}: coefficients must be (..., T, {f}), "
                         f"got {tuple(coeffs.shape)}")
    if len(window_bytes) != 8 * n:
        raise ValueError(f"{name}: the window must have {n} float64 "
                         f"samples, got {len(window_bytes)} bytes")
    batch = int(np.prod(lead, dtype=np.int64))
    _build.require_grid(batch, 1, name)
    dev = coeffs.device
    if t == 0 or batch == 0:
        out = torch.zeros((batch, (t + 1) * f), dtype=torch.float32,
                          device=dev)
    else:
        c = coeffs.reshape(batch, t, f).contiguous()
        out = torch.empty((batch, (t + 1) * f), dtype=torch.float32,
                          device=dev)
        err = _build.library().zt_imdct_ola_fft(
            c.data_ptr(), synthesis_window(window_bytes, torch.float32,
                                           dev).data_ptr(),
            twiddles(n, torch.float32, dev).data_ptr(),
            _rfft.kernel_tables(f, dev).data_ptr(),
            out.data_ptr(), batch, t, n, _build.stream_of(coeffs))
        _build.check(err, "zt_imdct_ola_fft")
        imdct_ola_fft.launches += 1
    return out.reshape(*lead, out.shape[-1])


def _check_fits(name: str, n: int) -> None:
    if not fits(n):
        raise ValueError(f"{name}: the window length must be a multiple of "
                         f"4 from 32 to {MAX_WINDOW} with no prime factor "
                         f"above {_rfft.MAX_PRIME} in its quarter, got {n}")


mdct_fft.launches = 0
imdct_ola_fft.launches = 0
