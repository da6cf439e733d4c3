"""Window functions, built on the host in numpy float64.

The same math as ``zaftpu.core.windows`` (reference zaf.py:74, :527, :1100,
:1004-1010), so the two packages' windows are bit-identical. Transforms
receive them as arrays and cast them to the signal's dtype and device.
"""

from __future__ import annotations

import numpy as np


def hamming(length: int, periodic: bool = True) -> np.ndarray:
    """Hamming window.

    ``periodic=True`` matches ``scipy.signal.hamming(length, sym=False)``
    (reference zaf.py:74), the DFT-even variant needed for constant
    overlap-add. ``periodic=False`` matches ``np.hamming`` (zaf.py:527).
    """
    if length == 1:
        return np.ones(1)
    denom = length if periodic else length - 1
    n = np.arange(length, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / denom)


def hann(length: int, periodic: bool = True) -> np.ndarray:
    """Hann window (periodic variant is COLA for step = length/2 or /4)."""
    if length == 1:
        return np.ones(1)
    denom = length if periodic else length - 1
    n = np.arange(length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)


def vorbis(length: int) -> np.ndarray:
    """Vorbis (sine-slope) MDCT window ``sin(pi/2 * sin^2(pi(n+1/2)/N))``
    (reference example zaf.py:1100)."""
    n = np.arange(0.5, length + 0.5, dtype=np.float64)
    return np.sin(np.pi / 2.0 * np.sin(np.pi * n / length) ** 2)


def kbd(length: int, alpha: float = 5.0) -> np.ndarray:
    """Kaiser-Bessel-derived window as the reference's example builds it
    (zaf.py:1004-1010), including its length ``length - 2`` quirk."""
    half = length // 2
    kaiser = np.kaiser(half + 1, alpha * np.pi)
    cumulated = np.cumsum(kaiser[1:half])
    return np.sqrt(
        np.concatenate((cumulated, cumulated[half::-1])) / np.sum(kaiser)
    )


def kbd_exact(length: int, alpha: float = 5.0) -> np.ndarray:
    """Standard Kaiser-Bessel-derived window of exactly ``length`` samples
    (``w[n] = sqrt(sum(kaiser[0..n]) / sum(kaiser))``, mirrored)."""
    half = length // 2
    kaiser = np.kaiser(half + 1, alpha * np.pi)
    cumulated = np.cumsum(kaiser[:half])
    first = np.sqrt(cumulated / np.sum(kaiser))
    return np.concatenate((first, first[::-1]))


def sine(length: int) -> np.ndarray:
    """MDCT sine window ``sin(pi(n+1/2)/N)``."""
    n = np.arange(0.5, length + 0.5, dtype=np.float64)
    return np.sin(np.pi * n / length)


_BY_NAME = {
    "hamming": hamming,
    "hann": hann,
    "vorbis": vorbis,
    "kbd": kbd,
    "kbd_exact": kbd_exact,
    "sine": sine,
}


def get_window(name: str, length: int, **kwargs) -> np.ndarray:
    """Look a window up by name (``hamming|hann|vorbis|kbd|sine``)."""
    try:
        fn = _BY_NAME[name]
    except KeyError:
        raise ValueError(
            f"unknown window {name!r}; available: {sorted(_BY_NAME)}"
        ) from None
    return fn(length, **kwargs)
