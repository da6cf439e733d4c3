"""Short-time Fourier transform, its inverse, and the magnitude spectrogram.

Semantics match ``zaftpu.transforms.stft`` and the reference
(zaf.py:45-243): the same centering pad and frame count, the full complex
``(window_length, number_times)`` output with DC and mirrored bins, and the
COLA-normalized inverse. On a CUDA float32 signal the analysis runs the
fused framing + window + real-FFT kernel at a power-of-two window (16 to
4096) and the fused framing + window + DFT-GEMM kernel at any other, and
the synthesis the fused inverse GEMM + overlap-add kernel
(:mod:`zaftpu_torch.kernels`), or under ``ZAFTPU_PRECISION=split4`` their
split4 twins; the spectrogram takes that half spectrum and ``|·|`` at a
power-of-two window and the one-pass magnitude kernel at any other
(:mod:`zaftpu_torch.kernels.melfused`). ``ZAFTPU_MIRROR=pallas`` moves the
conjugate mirror and the Hermitian fold into kernels, bit-equal to the
default; ``ZAFTPU_FULLSPEC=1`` writes the full spectrum from the GEMM
analysis kernel, within float32 rounding of the default at a window the
FFT takes.
On the CPU the same paths run their plain PyTorch versions, in the input's
dtype (float64 is the oracle mode).

Device rule: a signal or spectrum given as a tensor stays on its device
and keeps its dtype, so a CPU tensor is how a caller asks for the CPU;
anything else (a numpy array, a list) goes to the CUDA card as float32
(complex64 for a spectrum), and without a card it raises. The window and
the other arguments follow the signal's device. A bfloat16 signal computes
in float32, on the card too; ``mdct`` and ``imdct`` return it as bfloat16,
as ``zaftpu``'s do.
"""

from __future__ import annotations

import numpy as np
import torch

from zaftpu_torch import kernels as _kernels
from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core import frame as _frame
from zaftpu_torch.core import validate as _validate
from zaftpu_torch.kernels import melfused as _melfused


def _as_tensor(x) -> torch.Tensor:
    """A tensor as is; anything else copied into a CPU tensor (windows and
    other arguments, which then follow the signal's device)."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def _card_array(x) -> np.ndarray:
    """A non-tensor signal or spectrum as the array that goes to the card:
    a real floating array as float32 and a complex one as complex64, which
    is what ``zaftpu`` computes a float64 array (numpy's default, and what
    ``wavread`` returns) in on its accelerator. Any other dtype is kept for
    the validators to refuse."""
    a = np.asarray(x)
    if a.dtype.kind == "c":
        return a.astype(np.complex64)
    if a.dtype.kind == "f" and a.dtype != np.float16:
        return a.astype(np.float32)
    return a


def _as_input(x) -> torch.Tensor:
    """A signal or spectrum as a tensor: a tensor as is, on its device and
    in its dtype; anything else copied to the CUDA card in the dtype
    :func:`_card_array` gives it. Without a card that raises rather than
    quietly running on the CPU."""
    if isinstance(x, torch.Tensor):
        return x
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: a non-tensor input runs on the card; pass a CPU "
            "tensor (torch.from_numpy(x)) to run on the CPU")
    return torch.as_tensor(_card_array(x), device="cuda")


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


def _analysis_inputs(audio_signal, window_function, step_length, config):
    """The validated signal (at least float32: a bfloat16 one is promoted,
    on the card too), window (on the signal's device, in its dtype) and
    hop."""
    x = _validate.check_signal(_as_input(audio_signal))
    window, step = _resolve_analysis_args(window_function, step_length,
                                          config)
    win = _validate.check_window(_as_tensor(window))
    wl = win.shape[0]
    step = _validate.check_step(step, wl)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    _kernels.check_device_input(x, wl)
    return x, win.to(device=x.device, dtype=x.dtype), step


def centre_padded(x: torch.Tensor, window_length: int, step: int):
    """The centre-padded signal and its frame count (zaf.py:99-125)."""
    pad_front, pad_back, t = _frame.stft_padding(x.shape[-1], window_length,
                                                 step)
    return torch.nn.functional.pad(x, (pad_front, pad_back)), t


def _stft_frames_half(x: torch.Tensor, window: torch.Tensor,
                      step: int) -> torch.Tensor:
    """Windowed frames -> rDFT, frames-major ``(..., T, WL/2+1)``, for the
    split magnitude and mel paths, which use only the non-mirrored bins.
    ``x`` and ``window`` as :func:`_analysis_inputs` gives them."""
    wl = window.shape[0]
    padded, t = centre_padded(x, wl, step)
    return _kernels.windowed_frames_rfft(padded, window, wl, step, t)


def stft(audio_signal, window_function=None, step_length: int | None = None,
         *, config=None) -> torch.Tensor:
    """Short-time Fourier transform.

    Inputs:
        audio_signal: real signal ``(number_samples,)`` or batched
            ``(..., number_samples)``, a tensor (on its device) or an array
            (sent to the card)
        window_function: window ``(window_length,)``
        step_length: hop in samples
        config: alternatively, a :class:`zaftpu_torch.config.StftConfig`
    Output:
        complex STFT ``(..., window_length, number_times)``: the full
        spectrum with DC and mirrored bins, as reference zaf.py:45-141
        returns it. It is a transposed view of a frames-major tensor.
    """
    x, win, step = _analysis_inputs(audio_signal, window_function,
                                    step_length, config)
    wl = win.shape[0]
    padded, t = centre_padded(x, wl, step)
    full = _kernels.windowed_frames_rfft_fullspec(padded, win, wl, step, t)
    if full is None:
        half = _kernels.windowed_frames_rfft(padded, win, wl, step, t)
        full = _fft.full_from_half(half, wl)
    return full.transpose(-1, -2)


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
    z = _validate.check_spectrum(_as_input(audio_stft))
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


def spectrogram(audio_signal, window_function=None,
                step_length: int | None = None, *,
                config=None) -> torch.Tensor:
    """Magnitude spectrogram over bins ``1..WL/2``, DC dropped and Nyquist
    kept: the reference's analysis slice ``abs(stft[1:WL/2+1, :])``
    (zaf.py:370), computed without the mirrored bins.

    Inputs as :func:`stft` (``config=`` takes a
    :class:`zaftpu_torch.config.StftConfig`). Output: real
    ``(..., window_length/2, number_times)``, a transposed view of a
    frames-major tensor. The one-pass magnitude kernel where
    :func:`zaftpu_torch.kernels.melfused.kernel_wanted`, else the half
    spectrum and ``|·|``.
    """
    x, win, step = _analysis_inputs(audio_signal, window_function,
                                    step_length, config)
    wl = win.shape[0]
    if _melfused.kernel_wanted(x.dtype, wl):
        padded, t = centre_padded(x, wl, step)
        spec = _melfused.spec_rows(padded, win, wl, step, t)
    else:
        spec = _stft_frames_half(x, win, step)[..., 1:].abs()
    return spec.transpose(-1, -2)
