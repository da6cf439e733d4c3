"""The CUDA kernels of the STFT/ISTFT, MDCT/IMDCT, magnitude/mel and CQT
paths, and their dispatch.

The same dispatch functions as ``zaftpu.pallas``, minus its silent-retry
machinery: a CPU tensor always takes the kernels' plain PyTorch versions,
and a CUDA tensor always launches a kernel or raises. No path catches a
kernel failure and carries on.

Six levers choose the kernels, with ``zaftpu``'s names and meaning:

* ``ZAFTPU_FUSED=0``: framing kernel + ``torch.matmul`` GEMM instead of
  the fused analysis kernels (STFT and MDCT);
* ``ZAFTPU_SYNTH=0``: ``torch.matmul`` inverse GEMM + OLA kernel instead of
  the fused synthesis kernel (ISTFT and IMDCT);
* ``ZAFTPU_MELFUSE=0``: the analysis dispatch's half spectrum, ``|·|`` and
  ``torch.matmul`` instead of the one-pass magnitude and mel kernels
  (:mod:`zaftpu_torch.kernels.melfused`); ``1`` forces those kernels, and
  unset it follows the shape rule below;
* ``ZAFTPU_FULLSPEC=1``: ``stft`` takes the full-spectrum analysis kernel,
  the conjugate mirror in its store (``fused.frames_rfft_full``, a GEMM at
  every window length), instead of the half-spectrum kernel and a separate
  mirror; off by default, and only with the fused analysis on;
* ``ZAFTPU_FUSED2=1``: the half spectrum through the two-output analysis
  kernel (``fused.frames_matmul2``, both components as float32 planes)
  instead of the complex-store one; off by default, equal values;
* ``ZAFTPU_MIRROR=pallas``: the STFT's conjugate mirror and the ISTFT's
  Hermitian fold run as kernels (:mod:`zaftpu_torch.kernels.mirror`)
  instead of PyTorch index ops; off by default.

The first two default to the fused kernels, the last three to off.

On the exact dial the half-spectrum analysis (``fused.frames_rfft`` and
``fused.frames_matmul2``) follows a shape rule: a power-of-two window
length from 16 to 4096 takes the real-FFT kernel
(:mod:`zaftpu_torch.kernels.rfft`), any other length the GEMM kernel. The
magnitude and mel front ends follow it too: at such a window they take
the FFT's half spectrum unless ``ZAFTPU_MELFUSE=1`` forces their kernels
(``melfused.kernel_wanted``).

One dial sets the arithmetic, ``ZAFTPU_PRECISION``
(:mod:`zaftpu_torch.core.policy`): ``highest`` (default) runs the exact
FP32 kernels; ``split4`` runs every float32 analysis and synthesis kernel
above as its split4 twin (four bf16 passes on the tensor cores, float32
sums) and the split dispatch's wide GEMMs as ``policy.split4_matmul``.
Under split4 the magnitude and mel front ends take the half spectrum of
the analysis kernel unless ``ZAFTPU_MELFUSE=1`` forces their kernels (the
exact ``spec_rows``, the mel kernel's twin), as in ``zaftpu``. ``high`` and
``default`` are refused on CUDA. The CQT has its own scheme,
``ZAFTPU_CQT_SCHEME`` (:mod:`zaftpu_torch.transforms.cqt`): a CUDA float32
CQT runs ``cqtslab.cqt_magnitudes_split4`` by default and the exact
``cqtslab.cqt_magnitudes`` under a pinned dial or ``exact``, as
``zaftpu``'s does on its TPU.
"""

from __future__ import annotations

import os

import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core.policy import check_cuda_dial, real_matmul
from zaftpu_torch.kernels import framing as _framing
from zaftpu_torch.kernels import fused as _fused
from zaftpu_torch.kernels import mirror as _mirror
from zaftpu_torch.kernels import ola as _ola
from zaftpu_torch.kernels import synth as _synth
# Largest window the direct DFT GEMM and the real-FFT kernel cover; longer
# ones need the four-step FFT, which is not ported yet.
from zaftpu_torch.kernels.rfft import MAX_WINDOW


def fused_enabled() -> bool:
    return os.environ.get("ZAFTPU_FUSED", "auto") != "0"


def synth_enabled() -> bool:
    return os.environ.get("ZAFTPU_SYNTH", "auto") != "0"


def check_device_input(x: torch.Tensor, window_length: int) -> None:
    """Raise ``NotImplementedError`` for a CUDA input the kernels do not
    take: anything but float32 (complex64 spectra; callers promote a
    bfloat16 signal to float32 first), a window above :data:`MAX_WINDOW`,
    or the TPU-only dials ``high`` and ``default``. CPU inputs are always
    taken."""
    if not x.is_cuda:
        return
    check_cuda_dial()
    if x.dtype not in (torch.float32, torch.complex64):
        raise NotImplementedError(
            f"the CUDA path takes float32 signals and complex64 spectra, got "
            f"{x.dtype}")
    if window_length > MAX_WINDOW:
        raise NotImplementedError(
            f"window_length {window_length} > {MAX_WINDOW} needs the "
            "four-step FFT, which the CUDA path does not have yet")


def windowed_frames(padded, window, window_length: int, step: int,
                    number_times: int):
    """Windowed overlapped frames ``(..., T, WL)``."""
    return _framing.frame_window(padded, window, window_length, step,
                                 number_times)


def windowed_frames_rfft(padded, window, window_length: int, step: int,
                         number_times: int):
    """Windowed overlapped frames -> rDFT half spectrum ``(..., T, WL/2+1)``:
    the fused kernel, or with ``ZAFTPU_FUSED=0`` the framing kernel followed
    by the DFT GEMM."""
    if fused_enabled():
        return _fused.frames_rfft(padded, window, window_length, step,
                                  number_times)
    frames = windowed_frames(padded, window, window_length, step,
                             number_times)
    return _fft.direct_rfft(frames)


def windowed_frames_rfft_fullspec(padded, window, window_length: int,
                                  step: int, number_times: int):
    """Windowed overlapped frames -> full spectrum ``(..., T, WL)`` with the
    conjugate mirror written by the analysis kernel, or ``None`` unless
    ``ZAFTPU_FULLSPEC=1`` and the fused analysis is on (the caller then
    mirrors the half spectrum). Bit-equal to that composition."""
    if _fused.fullspec_enabled() and fused_enabled():
        return _fused.frames_rfft_full(padded, window, window_length, step,
                                       number_times)
    return None


def overlap_add(frames, step: int):
    """Overlap-add ``(..., T, WL)`` frames into
    ``(..., T*step + WL - step)``."""
    return _ola.overlap_add(frames, step)


def synthesis_ola(spectra, step: int, gain: float = 1.0):
    """Synthesis back end from bins-major spectra ``(..., N, T)``:
    ``overlap_add(real(ifft(spectraᵀ)), step) / gain``, with the division
    folded into the inverse operator. The Hermitian fold runs as PyTorch
    index ops, or with ``ZAFTPU_MIRROR=pallas`` as the fold kernel; then
    the fused synthesis kernel, or with ``ZAFTPU_SYNTH=0`` the inverse GEMM
    followed by the OLA kernel."""
    n = spectra.shape[-2]
    fm = spectra.transpose(-1, -2)
    if _mirror.enabled():
        h_re, h_im = _mirror.fold_half_planes(fm, n)
    else:
        h_re, h_im = _fft.hermitian_fold_planes(fm.real, fm.imag, n)
    if synth_enabled():
        return _synth.istft_ola(h_re, h_im, n, step, 1.0 / gain)
    frames = _fft.direct_real_ifft_folded(h_re, h_im, n, scale=1.0 / gain)
    return overlap_add(frames, step)


def imdct_synthesis(coeffs, f: int, window_bytes: bytes):
    """IMDCT synthesis from frames-major coefficients ``(..., T, F)``:
    ``overlap_add(coeffs @ M_w, F)`` with M_w the window-folded inverse
    operator (keyed by the float64 window's bytes), ``(..., T*F + F)``
    before the trim. The fused synthesis kernel, or with ``ZAFTPU_SYNTH=0``
    the inverse GEMM (honouring the dial) followed by the OLA kernel."""
    if synth_enabled():
        return _synth.imdct_ola(coeffs, f, window_bytes)
    ops = _synth.imdct_ops(f, window_bytes, coeffs.dtype, coeffs.device)
    return overlap_add(real_matmul(coeffs, ops[:f]), f)
