"""Griffin-Lim phase reconstruction (magnitude spectrogram -> waveform).

Semantics match ``zaftpu.transforms.griffinlim``: the magnitude is ``(WL/2
+ 1, T)`` over bins 0..WL/2; the phase starts at zero; each iteration
synthesizes ``real(ifft(full spectrum)) * window``, overlap-adds it and
divides by the window-square envelope ``wsq`` (floored at 1e-12), frames
the *unpadded* result at ``j * step`` times the window, takes its half
spectrum and projects the phase, with fast Griffin-Lim's momentum step
(``beta = m / (1 + m)``, the magnitude floored at 1e-16); the result is
trimmed by ``WL - step`` on each side, as :func:`zaftpu_torch.istft` trims.

At a window of the FFT shape rule (:func:`zaftpu_torch.kernels.rfft.
applies`) each iteration runs two kernels on the card, on both dials: the
real-FFT kernel's half store for the analysis
(:func:`zaftpu_torch.kernels.rfft.frames_rfft_fft`) and the inverse real-FFT
kernel's windowed store for the synthesis
(:func:`zaftpu_torch.kernels.irfft.istft_ola_fft_window`, which reads the
complex half spectrum as it is, no copy of its planes). At any other
window, or under ``ZAFTPU_FFT=matmul``, ``zaftpu``'s composition on the
port's dispatch:
``kernels.windowed_frames_rfft`` (the real-FFT kernel's half store at every
window up to 4096, its ``rfft_any`` off that rule; the GEMM B1 under
``ZAFTPU_FFT=matmul``; the framing kernel and the FFT layer's ``rfft``
above 4096), ``core.fft.real_ifft`` of the mirrored
spectrum times the window, the OLA kernel and ``/ wsq``. The envelope is
the OLA kernel's, once a call; the phase projection is plain elementwise
PyTorch on the card, as in ``zaftpu``. CPU tensors run the kernels' plain
versions, in the input's dtype (float64 in, float64 out).
"""

from __future__ import annotations

import torch

from zaftpu_torch import kernels as _kernels
from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core import validate as _validate
from zaftpu_torch.kernels import irfft as _irfft
from zaftpu_torch.kernels import rfft as _rfft
from zaftpu_torch.transforms.stft import _as_input, _as_tensor

_EPS = 1e-16
_WSQ_FLOOR = 1e-12


def griffin_lim(magnitude, window_function, step_length: int,
                iterations: int = 32, momentum: float = 0.99) -> torch.Tensor:
    """Reconstruct a waveform from a magnitude spectrogram.

    Inputs:
        magnitude: ``(WL/2+1, T)`` nonnegative magnitudes of bins
            0..WL/2, a tensor (on its device) or an array (sent to the
            card)
        window_function: COLA analysis window ``(WL,)``
        step_length: hop in samples
        iterations: projections
        momentum: fast Griffin-Lim acceleration (0 = classic)
    Output:
        real signal ``(T*step - WL + step,)`` (the ISTFT's trim)
    """
    mag = _validate.check_signal(_as_input(magnitude), "magnitude")
    if mag.ndim != 2:
        raise ValueError(f"magnitude must be (window_length/2 + 1, "
                         f"number_times), got {tuple(mag.shape)}")
    mag = mag.to(torch.promote_types(mag.dtype, torch.float32))
    _kernels.check_device_input(mag)
    win = _validate.check_window(_as_tensor(window_function)).to(
        device=mag.device, dtype=mag.dtype)
    wl = win.shape[0]
    step = _validate.check_step(step_length, wl)
    if mag.shape[0] != wl // 2 + 1:
        raise ValueError(f"magnitude must have window_length/2 + 1 = "
                         f"{wl // 2 + 1} bins, got {mag.shape[0]}")
    mag_tf = mag.T.contiguous()  # (T, WL/2+1), frames-major
    t = mag_tf.shape[0]
    wsq = _kernels.overlap_add((win * win).expand(t, wl), step).clamp_min(
        _WSQ_FLOOR)
    on_rule = _rfft.applies(wl)

    def synthesize(spec: torch.Tensor) -> torch.Tensor:
        if on_rule:
            return _irfft.istft_ola_fft_window(spec, wl, step, win, wsq)
        frames = _fft.real_ifft(_fft.full_from_half(spec, wl)) * win
        return _kernels.overlap_add(frames, step) / wsq

    def analyze(signal: torch.Tensor) -> torch.Tensor:
        if on_rule:
            return _rfft.frames_rfft_fft(signal, win, wl, step, t)
        return _kernels.windowed_frames_rfft(signal, win, wl, step, t)

    beta = momentum / (1.0 + momentum)
    angles = torch.ones_like(mag_tf, dtype=_fft.complex_dtype(mag.dtype))
    prev = torch.zeros_like(angles)
    spec = torch.empty_like(angles)
    for _ in range(int(iterations)):
        rebuilt = analyze(synthesize(torch.mul(mag_tf, angles, out=spec)))
        # accel = rebuilt - beta * prev, in prev's buffer.
        accel = torch.sub(rebuilt, prev.mul_(beta), out=prev)
        torch.div(accel, accel.abs().clamp_min_(_EPS), out=angles)
        prev = rebuilt
    signal = synthesize(torch.mul(mag_tf, angles, out=spec))
    edge = wl - step
    return signal[edge:signal.shape[-1] - edge]
