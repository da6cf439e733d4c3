"""The CUDA kernels of the STFT/ISTFT, MDCT/IMDCT, magnitude/mel and CQT
paths, and their dispatch.

The same dispatch functions as ``zaftpu.pallas``, minus its silent-retry
machinery: a CPU tensor always takes the kernels' plain PyTorch versions,
and a CUDA tensor always launches a kernel or raises. No path catches a
kernel failure and carries on.

Seven levers choose the kernels, with ``zaftpu``'s names and meaning:

* ``ZAFTPU_FUSED=0``: framing kernel + ``torch.matmul`` GEMM instead of
  the fused analysis kernels (STFT and MDCT);
* ``ZAFTPU_SYNTH=0``: ``torch.matmul`` inverse GEMM + OLA kernel instead of
  the fused synthesis kernel (ISTFT and IMDCT);
* ``ZAFTPU_MELFUSE=0``: the analysis dispatch's half spectrum, ``|·|`` and
  ``torch.matmul`` instead of the real-FFT kernel's magnitude and mel
  stores (:mod:`zaftpu_torch.kernels.melfft`) or the one-pass magnitude
  and mel GEMM kernels (:mod:`zaftpu_torch.kernels.melfused`); ``1``
  forces the GEMM kernels where the stores' rule below does not give the
  stores, and unset it follows the rule (``melfused.route``);
* ``ZAFTPU_FULLSPEC``: ``1`` makes ``stft`` take the full-spectrum
  analysis kernel, the conjugate mirror in its store
  (``fused.frames_rfft_full``: the real-FFT kernel's full store where the
  shape rule below holds, the GEMM B3 or its twin elsewhere), at every
  window; ``0`` the half-spectrum kernel and a separate mirror; unset, the
  full store at the shape rule's windows unless ``ZAFTPU_MIRROR=pallas`` or
  ``ZAFTPU_FUSED2=1`` is set, and the half spectrum and mirror elsewhere
  (``fused.fullspec_enabled``); only with the fused analysis on;
* ``ZAFTPU_FUSED2=1``: the half spectrum through the two-output analysis
  kernel (``fused.frames_matmul2``, both components as float32 planes)
  instead of the complex-store one; off by default, equal values;
* ``ZAFTPU_MIRROR=pallas``: the STFT's conjugate mirror and the ISTFT's
  Hermitian fold run as kernels (:mod:`zaftpu_torch.kernels.mirror`)
  instead of PyTorch index ops (or, for the fold from 16 to 4096, the
  inverse kernel's load); off by default;
* ``ZAFTPU_FFT=matmul``: the DFT and its inverse as GEMMs at every
  window, which turns the shape rule below off (``auto``, the default,
  and ``native`` follow it), and the CQT's time-domain kernels at every
  FFT length; ``zaftpu``'s FFT-engine lever.

The first two default to the fused kernels, ``ZAFTPU_MELFUSE``,
``ZAFTPU_FULLSPEC`` and ``ZAFTPU_FFT`` to the shape rule, the other two to
off.

On every dial the spectral analyses follow one shape rule
(``rfft.half_applies``: every window length from 16 to 4096, no explicit
operator, ``ZAFTPU_FFT`` not ``matmul``): the full-spectrum analysis
(``fused.frames_rfft_full``) takes the real-FFT kernel's full store, the
half-spectrum analysis (``fused.frames_rfft``, and ``fused.frames_matmul2``
as two planes) its half and planes stores (:mod:`zaftpu_torch.kernels.rfft`),
and the fused ISTFT synthesis (``synth.istft_ola``) the inverse real-FFT +
overlap-add kernel (:mod:`zaftpu_torch.kernels.irfft`, ``irfft.applies``),
which reads ``istft``'s full spectrum itself, the Hermitian fold in its
load (``irfft.istft_ola_fft_full``);
the magnitude and mel front ends take its magnitude and mel stores
(:mod:`zaftpu_torch.kernels.melfft`, ``melfft.applies``): an odd window a
complex FFT a frame, a prime factor above 127 by Bluestein. The front ends
do so unless ``ZAFTPU_MELFUSE=0`` asks for the half spectrum;
``ZAFTPU_FFT=matmul`` (or a window below 16) gives all six functions to
the GEMMs B1, B12, B3, B4, B8 and B9 or their twins
(``melfused.route``). The MDCT and IMDCT follow the static path's rule
(``rfft.applies``) at a quarter of the window (``mdct.applies``: a
multiple of 4 up to 4096 whose
quarter has no prime factor above 127): the fast MDCT kernel and the fast
IMDCT + overlap-add kernel (:mod:`zaftpu_torch.kernels.mdct`) there, the
GEMMs ``fused.frames_op`` and ``synth.imdct_ola`` (their twins under
split4) at any other length, with an explicit operator or under
``ZAFTPU_FFT=matmul``.

One dial sets the arithmetic, ``ZAFTPU_PRECISION``
(:mod:`zaftpu_torch.core.policy`): ``highest`` (default) runs the exact
FP32 kernels; ``split4`` runs every float32 GEMM analysis and synthesis
kernel above as its split4 twin (four bf16 passes on the tensor cores,
float32 sums) and the split dispatch's wide GEMMs as
``policy.split_matmul``; on CUDA ``high`` and ``default`` run the same
twins at three and one pass (``policy.gemm_passes``) and every operator
GEMM of the split dispatch at that count, and on the CPU they run exact;
the FFT kernels, exact and faster than the twins, serve every dial
wherever their shape rules hold, so from WL 16 to 4096 the STFT and ISTFT
of a lowered dial are the exact dial's.
Off the stores' rule (below 16, or under ``ZAFTPU_FFT=matmul``), under
split4 the magnitude and mel front ends take the half spectrum of the
analysis kernel unless ``ZAFTPU_MELFUSE=1`` forces their kernels (the
exact ``spec_rows``, the mel kernel's twin), as in ``zaftpu``. A float32 CQT whose FFT length is a
power of two up to 131,072 runs the spectral CQT kernel
(:mod:`zaftpu_torch.kernels.cqtfft`: each frame's real FFT and the
kernel's nonzeros; at 65,536 on a cluster of two blocks, at 131,072 of
four) on every scheme
and dial (``cqtfft.applies``); at any
other length or under ``ZAFTPU_FFT=matmul`` the CQT has its own scheme,
``ZAFTPU_CQT_SCHEME`` (:mod:`zaftpu_torch.transforms.cqt`): a CUDA float32
CQT runs ``cqtslab.cqt_magnitudes_split4`` by default, at the dial's pass
count under ``high`` or ``default``, at one pass under the bf16 compute
dtype, and the exact ``cqtslab.cqt_magnitudes`` under a pinned
``highest`` or ``exact``, as
``zaftpu``'s does on its TPU.

A window above :data:`MAX_WINDOW` takes ``zaftpu``'s off-engine
composition on both dials and under every lever: the framing kernel and
:func:`zaftpu_torch.core.fft.rfft` for the analysis (``torch.fft``; the
four-step engine at a power of two under ``ZAFTPU_FFT=matmul``), :func:`zaftpu_torch.core.fft.
real_ifft`, the OLA kernel and the gain division for the synthesis; the
magnitude and mel front ends take that half spectrum (``melfused.route``)
and the MDCT its FFT core (:mod:`zaftpu_torch.transforms.mdct`).
"""

from __future__ import annotations

import os

import torch

from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core.policy import real_matmul
from zaftpu_torch.kernels import framing as _framing
from zaftpu_torch.kernels import fused as _fused
from zaftpu_torch.kernels import irfft as _irfft
from zaftpu_torch.kernels import mirror as _mirror
from zaftpu_torch.kernels import ola as _ola
from zaftpu_torch.kernels import synth as _synth
# Largest window the kernels' analysis and synthesis take; longer ones run
# the framing kernel, the FFT layer and OLA.
from zaftpu_torch.kernels.rfft import MAX_WINDOW


def fused_enabled() -> bool:
    return os.environ.get("ZAFTPU_FUSED", "auto") != "0"


def synth_enabled() -> bool:
    return os.environ.get("ZAFTPU_SYNTH", "auto") != "0"


def check_device_input(x: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` for a CUDA input the kernels do not
    take: anything but float32 (complex64 spectra; callers promote a
    bfloat16 signal to float32 first). CPU inputs are always taken."""
    if not x.is_cuda:
        return
    if x.dtype not in (torch.float32, torch.complex64):
        raise NotImplementedError(
            f"the CUDA path takes float32 signals and complex64 spectra, got "
            f"{x.dtype}")


def windowed_frames(padded, window, window_length: int, step: int,
                    number_times: int):
    """Windowed overlapped frames ``(..., T, WL)``."""
    return _framing.frame_window(padded, window, window_length, step,
                                 number_times)


def windowed_frames_rfft(padded, window, window_length: int, step: int,
                         number_times: int):
    """Windowed overlapped frames -> rDFT half spectrum ``(..., T, WL/2+1)``:
    the fused kernel, or with ``ZAFTPU_FUSED=0`` the framing kernel followed
    by the DFT GEMM; above :data:`MAX_WINDOW` the framing kernel followed
    by :func:`zaftpu_torch.core.fft.rfft`."""
    if window_length > MAX_WINDOW:
        return _fft.rfft(windowed_frames(padded, window, window_length, step,
                                         number_times))
    if fused_enabled():
        return _fused.frames_rfft(padded, window, window_length, step,
                                  number_times)
    frames = windowed_frames(padded, window, window_length, step,
                             number_times)
    return _fft.direct_rfft(frames)


def windowed_frames_rfft_fullspec(padded, window, window_length: int,
                                  step: int, number_times: int):
    """Windowed overlapped frames -> full spectrum ``(..., T, WL)`` with the
    conjugate mirror written by the analysis kernel, or ``None`` unless the
    fused analysis is on and ``fused.fullspec_enabled`` (the caller then
    mirrors the half spectrum), and ``None`` above :data:`MAX_WINDOW`.
    Bit-equal to that composition."""
    if (window_length <= MAX_WINDOW and fused_enabled()
            and _fused.fullspec_enabled(window_length)):
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
    folded into the inverse transform. Where the inverse real-FFT kernel's
    shape rule holds (``irfft.applies``: every window from 16 to 4096, not
    ``ZAFTPU_FFT=matmul``) with the fused synthesis on and
    ``ZAFTPU_MIRROR`` not ``pallas``, one launch: that kernel reading the
    Hermitian fold in its load (``irfft.istft_ola_fft_full``, the spectrum
    in its own strides). Elsewhere the fold runs first, as PyTorch index
    ops or with ``ZAFTPU_MIRROR=pallas`` as the fold kernel; then the fused
    synthesis (under ``ZAFTPU_MIRROR=pallas`` the inverse real-FFT kernel
    on the fold's planes, else the inverse GEMM kernel or its twin), or
    with ``ZAFTPU_SYNTH=0`` the inverse GEMM followed by the OLA kernel.
    Above
    :data:`MAX_WINDOW`, ``zaftpu``'s off-engine composition:
    :func:`zaftpu_torch.core.fft.real_ifft`, the OLA kernel, ``/ gain``."""
    n = spectra.shape[-2]
    fm = spectra.transpose(-1, -2)
    if n > MAX_WINDOW:
        out = overlap_add(_fft.real_ifft(fm), step)
        return out / gain if gain != 1.0 else out
    if synth_enabled() and not _mirror.enabled() and _irfft.applies(n):
        return _irfft.istft_ola_fft_full(fm, n, step, 1.0 / gain)
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
    before the trim. The fused synthesis (the fast IMDCT + overlap-add
    kernel where the MDCT's shape rule holds, else the inverse GEMM kernel
    or its twin), or with ``ZAFTPU_SYNTH=0`` the inverse GEMM (honouring
    the dial) followed by the OLA kernel."""
    if synth_enabled():
        return _synth.imdct_ola(coeffs, f, window_bytes)
    ops = _synth.imdct_ops(f, window_bytes, coeffs.dtype, coeffs.device)
    return overlap_add(real_matmul(coeffs, ops[:f]), f)
