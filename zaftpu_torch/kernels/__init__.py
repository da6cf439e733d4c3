"""The four CUDA kernels of the STFT/ISTFT path and their dispatch.

The same dispatch functions as ``zaftpu.pallas``, minus its silent-retry
machinery: a CPU tensor always takes the kernels' plain PyTorch versions,
and a CUDA tensor always launches a kernel or raises. No path catches a
kernel failure and carries on.

Two levers choose the kernels, with ``zaftpu``'s names and meaning:

* ``ZAFTPU_FUSED=0``: framing kernel + ``torch.matmul`` DFT GEMM instead of
  the fused analysis kernel;
* ``ZAFTPU_SYNTH=0``: ``torch.matmul`` inverse GEMM + OLA kernel instead of
  the fused synthesis kernel.

Both default to the fused kernels.
"""

from __future__ import annotations

import os

import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.kernels import framing as _framing
from zaftpu_torch.kernels import fused as _fused
from zaftpu_torch.kernels import ola as _ola
from zaftpu_torch.kernels import synth as _synth

# Largest window the direct DFT GEMM covers; longer ones need the four-step
# FFT, which is not ported yet.
MAX_WINDOW = 4096


def fused_enabled() -> bool:
    return os.environ.get("ZAFTPU_FUSED", "auto") != "0"


def synth_enabled() -> bool:
    return os.environ.get("ZAFTPU_SYNTH", "auto") != "0"


def check_device_input(x: torch.Tensor, window_length: int) -> None:
    """Raise ``NotImplementedError`` for a CUDA input the kernels do not
    take: anything but float32 (complex64 spectra) or a window above
    :data:`MAX_WINDOW`. CPU inputs are always taken."""
    if not x.is_cuda:
        return
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


def overlap_add(frames, step: int):
    """Overlap-add ``(..., T, WL)`` frames into
    ``(..., T*step + WL - step)``."""
    return _ola.overlap_add(frames, step)


def synthesis_ola(spectra, step: int, gain: float = 1.0):
    """Synthesis back end from bins-major spectra ``(..., N, T)``:
    ``overlap_add(real(ifft(spectraᵀ)), step) / gain``, with the division
    folded into the inverse operator. The Hermitian fold runs in plain
    PyTorch; then the fused synthesis kernel, or with ``ZAFTPU_SYNTH=0`` the
    inverse GEMM followed by the OLA kernel."""
    n = spectra.shape[-2]
    fm = spectra.transpose(-1, -2)
    h_re, h_im = _fft.hermitian_fold_planes(fm.real, fm.imag, n)
    if synth_enabled():
        return _synth.istft_ola(h_re, h_im, n, step, 1.0 / gain)
    frames = _fft.direct_real_ifft_folded(h_re, h_im, n, scale=1.0 / gain)
    return overlap_add(frames, step)
