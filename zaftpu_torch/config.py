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


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Frozen snapshot of the ``ZAFTPU_*`` dispatch levers the port reads,
    with the precision dial and the resolved operator-GEMM dtype
    (``zaftpu.config.DispatchConfig``, its config.py:116-192).

    ``zaftpu`` keys its jit caches on this snapshot; the port traces
    nothing and reads every lever at each call, so here it is an export and
    a record of what a run was under. Left out, because the port does not
    read those levers: ``fft_direct_max`` (the direct GEMM's bound is the
    constant 4096), ``cfft``, ``mirror_strategy``, ``pallas``,
    ``sharded_fuse``, ``budget``, ``fused_block`` and ``synth_block``.
    """

    fft: str = "auto"
    mirror: str = ""
    fused: str = ""
    fused2: str = ""
    melfuse: str = ""
    fullspec: str = ""
    synth: str = ""
    cqt_scheme: str = "auto"
    precision: str = "highest"
    matmul_dtype: str = ""

    @classmethod
    def current(cls) -> "DispatchConfig":
        """Snapshot the environment and the compute-dtype context now."""
        import os

        from zaftpu_torch.core import policy as _policy

        env = os.environ.get
        return cls(
            fft=env("ZAFTPU_FFT", "auto"),
            mirror=env("ZAFTPU_MIRROR", ""),
            fused=env("ZAFTPU_FUSED", ""),
            fused2=env("ZAFTPU_FUSED2", ""),
            melfuse=env("ZAFTPU_MELFUSE", ""),
            fullspec=env("ZAFTPU_FULLSPEC", ""),
            synth=env("ZAFTPU_SYNTH", ""),
            # An explicit dial changes what the CQT's auto scheme resolves
            # to (transforms/cqt._slab_scheme_split4), as in zaftpu.
            cqt_scheme=env("ZAFTPU_CQT_SCHEME", "auto") + (
                ":pinned" if env("ZAFTPU_PRECISION") else ""),
            precision=env("ZAFTPU_PRECISION", "highest").lower(),
            matmul_dtype=("bfloat16" if _policy.matmul_dtype() is not None
                          else ""),
        )
