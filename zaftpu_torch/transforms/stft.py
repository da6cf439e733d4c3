"""Short-time Fourier transform and its inverse.

Semantics match ``zaftpu.transforms.stft`` and the reference
(zaf.py:45-243): the same centering pad and frame count, the full complex
``(window_length, number_times)`` output with DC and mirrored bins, and the
COLA-normalized inverse. On a CUDA float32 signal the analysis runs the
fused framing + window + DFT kernel and the synthesis the fused inverse
GEMM + overlap-add kernel (:mod:`zaftpu_torch.kernels`); on the CPU the
same path runs their plain PyTorch versions, in the input's dtype (float64
is the oracle mode).
"""

from __future__ import annotations

import numpy as np
import torch

from zaftpu_torch import kernels as _kernels
from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core import frame as _frame
from zaftpu_torch.core import validate as _validate


def _as_tensor(x) -> torch.Tensor:
    """A tensor as is; anything else copied into a CPU tensor."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def _host_window(window) -> np.ndarray:
    if isinstance(window, torch.Tensor):
        return window.detach().to("cpu", torch.float64).numpy()
    return np.asarray(window, dtype=np.float64)


def _resolve_analysis_args(window_function, step_length, config):
    """The (window, step) pair from either positional arguments or a
    :class:`zaftpu_torch.config.StftConfig`-style ``config``, never both."""
    if config is not None:
        if window_function is not None or step_length is not None:
            raise ValueError(
                "pass either (window_function, step_length) or config=, "
                "not both")
        return config.window_array(), config.step_length
    if window_function is None or step_length is None:
        raise ValueError(
            "window_function and step_length are required when no config= "
            "is given")
    return window_function, step_length


def stft(audio_signal, window_function=None, step_length: int | None = None,
         *, config=None) -> torch.Tensor:
    """Short-time Fourier transform.

    Inputs:
        audio_signal: real signal ``(number_samples,)`` or batched
            ``(..., number_samples)``, a tensor (on its device) or an array
        window_function: window ``(window_length,)``
        step_length: hop in samples
        config: alternatively, a :class:`zaftpu_torch.config.StftConfig`
    Output:
        complex STFT ``(..., window_length, number_times)``: the full
        spectrum with DC and mirrored bins, as reference zaf.py:45-141
        returns it. It is a transposed view of a frames-major tensor.
    """
    x = _validate.check_signal(_as_tensor(audio_signal))
    window, step = _resolve_analysis_args(window_function, step_length,
                                          config)
    win = _validate.check_window(_as_tensor(window))
    wl = win.shape[0]
    step = _validate.check_step(step, wl)
    _kernels.check_device_input(x, wl)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    win = win.to(device=x.device, dtype=x.dtype)
    pad_front, pad_back, t = _frame.stft_padding(x.shape[-1], wl, step)
    padded = torch.nn.functional.pad(x, (pad_front, pad_back))
    half = _kernels.windowed_frames_rfft(padded, win, wl, step, t)
    return _fft.full_from_half(half, wl).transpose(-1, -2)


def istft(audio_stft, window_function=None, step_length: int | None = None,
          *, config=None) -> torch.Tensor:
    """Inverse short-time Fourier transform.

    Inputs:
        audio_stft: complex STFT ``(window_length, number_times)`` or
            batched ``(..., window_length, number_times)``, contiguous or
            not (the transposed view :func:`stft` returns is read as is)
        window_function: the analysis window ``(window_length,)``
        step_length: hop in samples
        config: alternatively, a :class:`zaftpu_torch.config.StftConfig`
    Output:
        real signal ``(..., number_times*step - window_length + step)``,
        with the reference's trim and normalization (zaf.py:144-243).
        Exact reconstruction needs a COLA window (periodic, step | WL).
    """
    z = _validate.check_spectrum(_as_tensor(audio_stft))
    window, step = _resolve_analysis_args(window_function, step_length,
                                          config)
    _validate.check_window(window)
    wl = z.shape[-2]
    step = _validate.check_step(step, wl)
    host_window = _host_window(window)
    gain = _frame.cola_gain(host_window, step)
    _validate.check_cola(host_window, step, gain)
    _kernels.check_device_input(z, wl)
    signal = _kernels.synthesis_ola(z, step, gain)
    # Trim the centering pad (zaf.py:236-238).
    edge = wl - step
    return signal[..., edge:signal.shape[-1] - edge]
