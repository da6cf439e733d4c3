"""zaftpu_torch: the STFT/ISTFT, MDCT/IMDCT, spectrogram/mel/MFCC and CQT
paths of zaftpu in PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (sm_90a).

It imports neither JAX nor ``zaftpu``; the tests hold it against both.
Tensors stay on the device they arrive on: CUDA float32 runs the kernels,
CPU tensors run their plain PyTorch versions (float64 is the oracle mode).
"""

from zaftpu_torch.config import (CqtConfig, MdctConfig, MelConfig,
                                 StftConfig)
from zaftpu_torch.core.windows import (get_window, hamming, hann, kbd,
                                       kbd_exact, sine, vorbis)
from zaftpu_torch.features.mel import melfilterbank, melspectrogram, mfcc
from zaftpu_torch.transforms.cqt import (cqtchromagram, cqtkernel,
                                         cqtspectrogram)
from zaftpu_torch.transforms.mdct import imdct, mdct
from zaftpu_torch.transforms.stft import istft, spectrogram, stft

__all__ = [
    "stft", "istft", "spectrogram", "mdct", "imdct",
    "melfilterbank", "melspectrogram", "mfcc",
    "cqtkernel", "cqtspectrogram", "cqtchromagram",
    "StftConfig", "MelConfig", "CqtConfig", "MdctConfig",
    "hamming", "hann", "vorbis", "kbd", "kbd_exact", "sine", "get_window",
]
