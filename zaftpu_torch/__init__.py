"""zaftpu_torch: the STFT/ISTFT, MDCT/IMDCT, spectrogram/mel/MFCC, CQT,
DCT/DST and Griffin-Lim paths of zaftpu in PyTorch, at every window
zaftpu takes, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a),
the precision dial and compute dtype, WAV I/O, the resumable streaming
pipeline (:mod:`zaftpu_torch.io.pipeline`), the display helpers and
``asnumpy``, and the bench suite (:mod:`zaftpu_torch.bench.harness`).

It imports neither JAX nor ``zaftpu``; the tests hold it against both.
Tensors stay on the device they arrive on: CUDA float32 runs the kernels,
CPU tensors run their plain PyTorch versions (float64 is the oracle mode).
"""

from zaftpu_torch.config import (CqtConfig, DispatchConfig, MdctConfig,
                                 MelConfig, StftConfig)
from zaftpu_torch.core import policy as _policy
from zaftpu_torch.core.policy import compute_dtype
from zaftpu_torch.core.windows import (get_window, hamming, hann, kbd,
                                       kbd_exact, sine, vorbis)
from zaftpu_torch.features.mel import melfilterbank, melspectrogram, mfcc
from zaftpu_torch.io.wav import wavread, wavwrite
from zaftpu_torch.transforms.cqt import (cqtchromagram, cqtkernel,
                                         cqtspectrogram)
from zaftpu_torch.transforms.dct import dct, dst
from zaftpu_torch.transforms.griffinlim import griffin_lim
from zaftpu_torch.transforms.mdct import imdct, mdct
from zaftpu_torch.transforms.stft import istft, spectrogram, stft
from zaftpu_torch.utils.fetch import asnumpy
from zaftpu_torch.viz.display import (cqtchromshow, cqtspecshow, melspecshow,
                                      mfccshow, sigplot, specshow)

# Set up MKL's vector math on this thread before the port's first CPU sqrt
# or log: set up from several threads at once, it can return approximate
# roots (policy.set_up_cpu_vector_math).
_policy.set_up_cpu_vector_math()

#: The bf16 compute dtype (``with zaftpu_torch.compute_dtype("bfloat16")``
#: or ``ZAFTPU_DTYPE=bfloat16``) is available, as in ``zaftpu``.
BF16_SUPPORTED = True

__all__ = [
    "stft", "istft", "spectrogram", "mdct", "imdct",
    "melfilterbank", "melspectrogram", "mfcc",
    "cqtkernel", "cqtspectrogram", "cqtchromagram", "dct", "dst",
    "griffin_lim", "wavread", "wavwrite",
    "sigplot", "specshow", "melspecshow", "mfccshow", "cqtspecshow",
    "cqtchromshow", "asnumpy",
    "StftConfig", "MelConfig", "CqtConfig", "MdctConfig", "DispatchConfig",
    "compute_dtype", "BF16_SUPPORTED",
    "hamming", "hann", "vorbis", "kbd", "kbd_exact", "sine", "get_window",
]
