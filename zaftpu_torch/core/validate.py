"""Input validation for the public transforms.

The same checks and messages as ``zaftpu.core.validate``: every public entry
point raises a clear ``ValueError`` up front instead of failing deep inside
a kernel (or, as the reference does at zaf.py:241, dividing by a near-zero
COLA gain).
"""

from __future__ import annotations

import numpy as np
import torch

_REAL_DTYPES = ("float32", "float64", "bfloat16")


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def check_signal(x: torch.Tensor, name: str = "audio_signal") -> torch.Tensor:
    """Real floating input of supported dtype with at least one sample."""
    if _dtype_name(x.dtype) not in _REAL_DTYPES:
        raise ValueError(
            f"{name} must be float32/float64/bfloat16 (got "
            f"{_dtype_name(x.dtype)}); f16/int inputs have no defined parity "
            "contract — cast first")
    if x.ndim == 0 or x.shape[-1] == 0:
        raise ValueError(
            f"{name} needs at least one sample, got shape {tuple(x.shape)}")
    return x


def check_spectrum(x: torch.Tensor, name: str = "audio_stft") -> torch.Tensor:
    """Complex input for inverse transforms."""
    if not x.is_complex():
        raise ValueError(
            f"{name} must be complex (got {_dtype_name(x.dtype)})")
    if x.ndim < 2:
        raise ValueError(
            f"{name} must be (window_length, number_times), got "
            f"{tuple(x.shape)}")
    return x


def check_window(window, name: str = "window_function", even: bool = False):
    """1-D window of length >= 2 (optionally even, for the MDCT's TDAC
    split; the reference silently floors odd lengths, zaf.py:1029)."""
    shape = (tuple(window.shape) if hasattr(window, "shape")
             else np.shape(window))
    if len(shape) != 1 or shape[0] < 2:
        raise ValueError(f"{name} must be 1-D with length >= 2, got {shape}")
    if even and shape[0] % 2 != 0:
        raise ValueError(
            f"{name} length must be even for the TDAC split (got {shape[0]}; "
            "the reference silently floors odd lengths — zaf.py:1029)")
    return window


def check_step(step_length: int, window_length: int) -> int:
    step_length = int(step_length)
    if not 1 <= step_length <= window_length:
        raise ValueError(
            f"step_length must be in [1, window_length={window_length}], "
            f"got {step_length}")
    return step_length


def check_cola(window: np.ndarray, step_length: int, gain: float) -> float:
    """Reject windows whose COLA gain is effectively zero: dividing by it
    would silently amplify garbage (reference zaf.py:241 divides blindly).
    ``window`` is a host array."""
    scale = float(np.abs(np.asarray(window, dtype=np.float64)).max())
    if abs(gain) <= 1e-9 * max(scale, 1e-30):
        raise ValueError(
            f"window has near-zero COLA gain {gain:.3e} at step "
            f"{step_length}: not a valid analysis/synthesis pair "
            "(use a periodic window with step dividing its length)")
    return gain
