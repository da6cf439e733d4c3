"""MDCT and inverse MDCT (TDAC), batched.

Semantics match ``zaftpu.transforms.mdct`` and the reference
(zaf.py:984-1184): fixed 50% overlap, ``T = ceil(N/step) + 1`` frames, a
caller-supplied TDAC window (Vorbis sine slope or KBD, see
:mod:`zaftpu_torch.core.windows`), and the inverse's overlap-add with the
reference's ``[F : -F-1]`` trim. Each direction is one GEMM against a host
float64 operator that folds the pre-twiddle, DFT, post-twiddle and real
part (and, for the inverse, the window) into one real matrix. On a CUDA
float32 signal the forward runs the fused framing + window + GEMM kernel
(``frames_op``) and the inverse the fused GEMM + TDAC overlap-add kernel
(``imdct_ola``), or under ``ZAFTPU_PRECISION=split4`` their split4 twins;
on the CPU the same path runs their plain PyTorch versions, in the input's
dtype (float64 is the oracle mode). The split dispatch's GEMMs
(``ZAFTPU_FUSED=0``, ``ZAFTPU_SYNTH=0``) go through ``policy.real_matmul``.

The inverse keys its window-folded operator by the float64 bytes of the
window. A window given as a tensor, on the CPU or the card, is copied to
the host once for that, as :func:`zaftpu_torch.istft` does for its COLA
gain, so the port needs no counterpart of ``zaftpu``'s unfused inverse for
traced or device-resident windows. The FFT cores for windows above 4096
(``zaftpu``'s ``_mdct_core`` / ``_imdct_core``) are not ported: on CUDA
such a window raises ``NotImplementedError``; on the CPU the direct GEMM
runs at any length.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch import kernels as _kernels
from zaftpu_torch.core import fft as _fft
from zaftpu_torch.core import validate as _validate
from zaftpu_torch.core.policy import real_matmul
from zaftpu_torch.kernels import fused as _fused
from zaftpu_torch.transforms.stft import (_as_input, _as_tensor,
                                          _host_window)


@lru_cache(maxsize=32)
def _forward_twiddles(window_length: int):
    """Pre/post twiddles of the forward MDCT (reference zaf.py:1047-1056)."""
    wl = window_length
    f = wl // 2
    pre = np.exp(-1j * np.pi / wl * np.arange(wl))
    post = np.exp(-1j * np.pi / wl * (f + 1) * np.arange(0.5, f + 0.5))
    return pre, post


@lru_cache(maxsize=32)
def _inverse_twiddles(number_frequencies: int):
    """Pre/post twiddles of the inverse MDCT (reference zaf.py:1138-1156)."""
    f = number_frequencies
    pre = np.exp(-1j * np.pi / (2 * f) * (f + 1) * np.arange(f))
    post = np.exp(
        -1j * np.pi / (2 * f) * np.arange(0.5 + f / 2, 2 * f + f / 2 + 0.5)
    ) / f
    return pre, post


@lru_cache(maxsize=16)
def _direct_forward_matrix(window_length: int):
    """The per-frame forward MDCT as one real ``(WL, WL/2)`` matrix,
    ``M[t, k] = Re(pre[t] * post[k] * exp(-2pi i tk/WL))`` (reference chain
    zaf.py:1047-1071). float64 host math."""
    wl = window_length
    f = wl // 2
    pre, post = _forward_twiddles(wl)
    tk = (np.arange(wl)[:, None] * np.arange(f)[None, :]) % wl
    ang = np.exp((-2j * np.pi / wl) * tk)
    return np.real(pre[:, None] * ang * post[None, :])


@lru_cache(maxsize=16)
def _direct_inverse_matrix(number_frequencies: int):
    """The per-frame inverse MDCT (before windowing) as one real
    ``(F, 2F)`` matrix, ``M[k, t] = 2*Re(pre[k] * post[t] *
    exp(-2pi i kt/(2F)))`` (reference chain zaf.py:1138-1170)."""
    f = number_frequencies
    pre, post = _inverse_twiddles(f)
    kt = (np.arange(f)[:, None] * np.arange(2 * f)[None, :]) % (2 * f)
    ang = np.exp((-2j * np.pi / (2 * f)) * kt)
    return 2.0 * np.real(pre[:, None] * ang * post[None, :])


@lru_cache(maxsize=8)
def _direct_forward_ops_padded(window_length: int,
                               rdtype_name: str = "float32"):
    """:func:`_direct_forward_matrix` as ``frames_op``'s ``(1, WL, F_pad)``
    stack, zero columns from F = WL/2 to whole 64-column tiles (a power-of-
    two window adds none)."""
    m = _direct_forward_matrix(window_length).astype(rdtype_name)
    f = m.shape[1]
    ops = np.zeros((1, window_length, _fused.padded_cols(f)), rdtype_name)
    ops[0, :, :f] = m
    return ops


@lru_cache(maxsize=16)
def _direct_inverse_windowed_matrix(number_frequencies: int,
                                    window_bytes: bytes):
    """:func:`_direct_inverse_matrix` with the TDAC window folded into its
    columns, ``(coeffs @ M) * win == coeffs @ (M * win)``. float64 host
    math, keyed by the float64 window's bytes."""
    win = np.frombuffer(window_bytes, dtype=np.float64)
    return _direct_inverse_matrix(number_frequencies) * win[None, :]


def _resolve_mdct_window(window_function, config):
    """Window from the positional argument or an
    :class:`zaftpu_torch.config.MdctConfig` (a float64 host array, cast to
    the input's dtype later), never both."""
    if config is not None:
        if window_function is not None:
            raise ValueError(
                "pass either window_function or config=, not both")
        return config.window_array()
    if window_function is None:
        raise ValueError("window_function is required when no config= is "
                         "given")
    return window_function


def mdct(audio_signal, window_function=None, *, config=None) -> torch.Tensor:
    """Modified discrete cosine transform.

    Inputs:
        audio_signal: real signal ``(number_samples,)`` or batched
            ``(..., number_samples)``, a tensor (on its device) or an array
            (sent to the card)
        window_function: TDAC window ``(window_length,)``, e.g.
            :func:`zaftpu_torch.vorbis` (zaf.py:1100) or ``kbd``
        config: alternatively, a :class:`zaftpu_torch.config.MdctConfig`
    Output:
        MDCT ``(..., window_length/2, number_times)`` with
        ``number_times = ceil(N/(WL/2)) + 1`` (reference zaf.py:984-1075),
        a transposed view of a frames-major tensor; bfloat16 for a bfloat16
        signal (computed in float32), as ``zaftpu``'s engine path returns
        it.
    """
    x = _validate.check_signal(_as_input(audio_signal))
    window = _resolve_mdct_window(window_function, config)
    win = _validate.check_window(_as_tensor(window), even=True)
    wl = win.shape[0]
    step = wl // 2
    in_dtype = x.dtype
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    _kernels.check_device_input(x, wl)
    win = win.to(device=x.device, dtype=x.dtype)
    n = x.shape[-1]
    t = int(np.ceil(n / step)) + 1
    # Pad `step` in front and to (T+1)*step in all (zaf.py:1036-1041).
    padded = torch.nn.functional.pad(x, (step, (t + 1) * step - n))
    args = (wl, _fft._real_name(x.dtype))
    if _kernels.fused_enabled():
        ops = _fused.dispatch_ops(_direct_forward_ops_padded, args, x.device,
                                  x.dtype)
        coeffs = _fused.frames_op(padded, win, ops, step, wl, step, t)
    else:
        frames = _kernels.windowed_frames(padded, win, wl, step, t)
        ops = _fft.device_operator(_direct_forward_ops_padded, args,
                                   x.device, x.dtype)
        coeffs = real_matmul(frames, ops[0, :, :step])
    if in_dtype == torch.bfloat16:
        coeffs = coeffs.to(in_dtype)
    return coeffs.transpose(-1, -2)


def imdct(audio_mdct, window_function=None, *, config=None) -> torch.Tensor:
    """Inverse MDCT with time-domain aliasing cancellation.

    Inputs:
        audio_mdct: MDCT ``(number_frequencies, number_times)`` or batched
            ``(..., F, T)``, contiguous or not (the transposed view
            :func:`mdct` returns is read as is)
        window_function: the TDAC analysis window ``(2*F,)``
        config: alternatively, a :class:`zaftpu_torch.config.MdctConfig`
    Output:
        real signal ``(..., F*(number_times+1) - 2F - 1)`` (reference
        zaf.py:1078-1184; perfect reconstruction up to rounding for TDAC
        windows); bfloat16 for bfloat16 coefficients (computed in float32),
        as ``zaftpu``'s engine path returns it.
    """
    c = _as_input(audio_mdct)
    if c.ndim < 2:
        raise ValueError(
            f"audio_mdct must be (number_frequencies, number_times), "
            f"got shape {tuple(c.shape)}")
    window = _resolve_mdct_window(window_function, config)
    _validate.check_window(window, even=True)
    host_window = _host_window(window)
    f = c.shape[-2]
    if host_window.shape[0] != 2 * f:
        raise ValueError(
            f"window length must be 2*number_frequencies = {2 * f}, got "
            f"{host_window.shape[0]}")
    coeffs = c.transpose(-1, -2)  # (..., T, F) frames-major
    coeffs = coeffs.to(torch.promote_types(coeffs.dtype, torch.float32))
    _kernels.check_device_input(coeffs, 2 * f)
    signal = _kernels.imdct_synthesis(coeffs, f, host_window.tobytes())
    if c.dtype == torch.bfloat16:
        signal = signal.to(c.dtype)
    # Reference trim [F : -F-1], one sample short on the right (zaf.py:1182).
    return signal[..., f:signal.shape[-1] - f - 1]
