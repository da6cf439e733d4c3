"""Frozen parameter dataclasses with the reference's documented defaults.

The same fields and defaults as ``zaftpu.config`` (reference conventions
zaf.py:67-77 and zaf.py:585-591). The public transforms accept them through
``config=`` in place of their positional parameters.
"""

from __future__ import annotations

import dataclasses
import math


def default_window_length(sampling_frequency: int | float,
                          window_duration: float = 0.04) -> int:
    """Power-of-two window length covering ``window_duration`` seconds
    (``2^ceil(log2(0.04*sr))``, 2048 at 44.1 kHz; zaf.py:67-71)."""
    return 2 ** int(math.ceil(math.log2(window_duration * sampling_frequency)))


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """STFT analysis parameters (reference zaf.py:45-141 conventions)."""

    window_length: int = 2048
    step_length: int = 1024
    window: str = "hamming"  # periodic (sym=False) for COLA, zaf.py:73-74

    @classmethod
    def for_rate(cls, sampling_frequency: int,
                 overlap: int = 2) -> "StftConfig":
        wl = default_window_length(sampling_frequency)
        return cls(window_length=wl, step_length=wl // overlap)

    def window_array(self):
        """The configured window as a float64 host array."""
        from zaftpu_torch.core.windows import get_window

        return get_window(self.window, self.window_length)


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Mel filterbank / MFCC parameters (reference zaf.py:353,410-414)."""

    sampling_frequency: int = 44100
    window_length: int = 2048
    number_mels: int = 40
    number_coefficients: int = 20
    step_length: int = 1024      # half overlap, reference zaf.py:75-77
    window: str = "hamming"      # periodic, reference zaf.py:73-74

    def window_array(self):
        """The configured analysis window as a float64 host array."""
        from zaftpu_torch.core.windows import get_window

        return get_window(self.window, self.window_length)

    def filterbank(self):
        """The configured mel filterbank (cached)."""
        from zaftpu_torch.features.mel import melfilterbank

        return melfilterbank(self.sampling_frequency, self.window_length,
                             self.number_mels)


@dataclasses.dataclass(frozen=True)
class CqtConfig:
    """CQT parameters (reference docstring defaults zaf.py:585-591)."""

    sampling_frequency: int = 44100
    octave_resolution: int = 24
    minimum_frequency: float = 55.0
    maximum_frequency: float = 3520.0
    time_resolution: int = 25

    def kernel(self):
        """The configured CQT kernel (memory- and disk-cached)."""
        from zaftpu_torch.transforms.cqt import cqtkernel

        return cqtkernel(self.sampling_frequency, self.octave_resolution,
                         self.minimum_frequency, self.maximum_frequency)


@dataclasses.dataclass(frozen=True)
class MdctConfig:
    """MDCT parameters; 50% overlap is structural (reference zaf.py:1029)."""

    window_length: int = 2048
    window: str = "vorbis"  # sine-slope window, zaf.py:1100

    def window_array(self):
        """The configured window as a float64 host array."""
        from zaftpu_torch.core.windows import get_window

        return get_window(self.window, self.window_length)
