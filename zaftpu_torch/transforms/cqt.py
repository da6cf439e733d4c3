"""Constant-Q transform: kernel, spectrogram, chromagram.

Semantics match ``zaftpu.transforms.cqt`` and the reference
(zaf.py:457-700). The kernel is a parameter-only precompute built on the
host in numpy complex128 with the same math as ``zaftpu`` (so the arrays
match bit for bit): per-channel symmetric-Hamming-windowed complex
exponentials of nearest-odd length, centred in an ``fft_length`` buffer,
FFT'd, thresholded at 0.01, conjugated and scaled by ``1/fft_length``. It is
cached in memory per parameter tuple and on disk
(:mod:`zaftpu_torch.utils.cache`).

Application follows the input's dtype, as ``zaftpu``'s does:

* float64 (the CPU oracle mode): frames in blocks of ``ZAFTPU_CQT_BLOCK``
  (default 1024), one batched ``rfft`` per block, a gather of the kernel's
  non-zero columns (conjugated where they are negative frequencies, by
  Hermitian symmetry), a complex GEMM and ``abs``;
* float32: the frame FFT folded into the operator, ``K @ FFT(x) ==
  FFT(K rows) @ x``, so the CQT is one ``(T, L) x (L, F)`` complex product
  per signal: on the card a hand-written kernel, on the CPU the exact plain
  slab loop of :func:`zaftpu_torch.kernels.cqtslab.cqt_magnitudes`. A CUDA
  float64 signal raises ``NotImplementedError``.

On the card the CQT has its own scheme, ``zaftpu``'s ``ZAFTPU_CQT_SCHEME``
(:func:`_slab_scheme_split4`): the split4 twin
(:func:`zaftpu_torch.kernels.cqtslab.cqt_magnitudes_split4`) by default,
the exact kernel when ``ZAFTPU_PRECISION`` is pinned to anything but
``split4`` or ``ZAFTPU_CQT_SCHEME=exact``. On the CPU the CQT stays exact
under every scheme, as ``zaftpu``'s does off its accelerator.

Not ported: the scoped-VMEM twins, the 128-lane hop padding and the
silent-retry wrapper.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import weakref
from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch.core import validate as _validate
from zaftpu_torch.core import windows as _windows
from zaftpu_torch.core.policy import check_cuda_dial, split4_enabled
from zaftpu_torch.kernels import cqtslab as _cqtslab
from zaftpu_torch.transforms.stft import _as_input
from zaftpu_torch.utils.cache import cached_operator


@dataclasses.dataclass(frozen=True)
class CqtKernel:
    """Precomputed CQT spectral kernel plus its reduced (banded) form.

    ``kernel`` matches the reference's ``cqtkernel(...).toarray()``
    (zaf.py:457-559) bit for bit. ``columns_low`` / ``columns_high`` index
    its non-zero columns in the non-negative / negative frequency halves;
    ``reduced_low`` / ``reduced_high`` are those column blocks, the float64
    path's operator. ``time_kernel`` is ``FFT(kernel rows)``, the float32
    path's.
    """

    kernel: np.ndarray            # (F, fft_length) complex128, thresholded
    columns_low: np.ndarray       # non-zero columns k <= L/2
    columns_high: np.ndarray      # non-zero columns k > L/2
    reduced_low: np.ndarray       # (F, len(columns_low)) complex128
    reduced_high: np.ndarray      # (F, len(columns_high)) complex128
    time_kernel: np.ndarray       # (F, fft_length) complex128

    @property
    def shape(self):
        return self.kernel.shape

    @property
    def number_frequencies(self) -> int:
        return self.kernel.shape[0]

    @property
    def fft_length(self) -> int:
        return self.kernel.shape[1]

    def toarray(self) -> np.ndarray:
        return self.kernel


@lru_cache(maxsize=8)
def _cqtkernel_cached(sampling_frequency: float, octave_resolution: int,
                      minimum_frequency: float,
                      maximum_frequency: float) -> CqtKernel:
    params = (sampling_frequency, octave_resolution, minimum_frequency,
              maximum_frequency)
    arrays = cached_operator(
        "cqtkernel", params,
        lambda: {"kernel": _build_cqt_kernel(*params)})
    return _finalize_kernel(arrays["kernel"])


def _build_cqt_kernel(sampling_frequency: float, octave_resolution: int,
                      minimum_frequency: float,
                      maximum_frequency: float) -> np.ndarray:
    # Constant quality factor Q = f_k / (f_{k+1} - f_k) (zaf.py:497).
    quality = 1.0 / (2.0 ** (1.0 / octave_resolution) - 1.0)
    number_frequencies = round(
        octave_resolution * np.log2(maximum_frequency / minimum_frequency))
    fft_length = int(2.0 ** np.ceil(
        np.log2(quality * sampling_frequency / minimum_frequency)))

    kernel = np.zeros((number_frequencies, fft_length), dtype=np.complex128)
    for i in range(number_frequencies):
        freq = minimum_frequency * 2.0 ** (i / octave_resolution)
        # Nearest odd length so the temporal kernel centres on 0
        # (zaf.py:521).
        length = 2 * round(quality * sampling_frequency / freq / 2) + 1
        offsets = np.arange(-(length - 1) / 2, (length - 1) / 2 + 1)
        temporal = (
            _windows.hamming(length, periodic=False)
            * np.exp(2j * np.pi * quality * offsets / length) / length
        )
        pad = (fft_length - length + 1) // 2
        kernel[i, pad:pad + length] = temporal

    kernel = np.fft.fft(kernel, axis=1)
    kernel[np.abs(kernel) < 0.01] = 0          # sparsity threshold zaf.py:551
    kernel = np.conj(kernel) / fft_length      # Parseval scaling zaf.py:557
    return kernel


def _finalize_kernel(kernel: np.ndarray) -> CqtKernel:
    fft_length = kernel.shape[1]
    nonzero_cols = np.nonzero(np.any(kernel != 0, axis=0))[0]
    half = fft_length // 2
    columns_low = nonzero_cols[nonzero_cols <= half]
    columns_high = nonzero_cols[nonzero_cols > half]
    # (K @ FFT(x))[i] = sum_n x[n] * FFT(K[i, :])[n] for any frame x, so the
    # time-domain operator FFT(kernel rows) applied to the frames equals the
    # reference's per-frame FFT + sparse matvec (zaf.py:627-633).
    time_kernel = np.fft.fft(kernel, axis=1)
    return CqtKernel(
        kernel=kernel,
        columns_low=columns_low,
        columns_high=columns_high,
        reduced_low=np.ascontiguousarray(kernel[:, columns_low]),
        reduced_high=np.ascontiguousarray(kernel[:, columns_high]),
        time_kernel=time_kernel,
    )


def cqtkernel(sampling_frequency, octave_resolution, minimum_frequency,
              maximum_frequency) -> CqtKernel:
    """Constant-Q spectral kernel (reference zaf.py:457-559 semantics).

    Returns a :class:`CqtKernel`; ``.toarray()`` gives the dense
    ``(number_frequencies, fft_length)`` complex matrix identical to the
    reference's sparse kernel densified.
    """
    return _cqtkernel_cached(float(sampling_frequency),
                             int(octave_resolution),
                             float(minimum_frequency),
                             float(maximum_frequency))


# Foreign kernels (anything but a CqtKernel) finalized once each: by weak
# reference where the object allows it (numpy arrays, scipy sparse
# matrices, tensors), else by content hash (nested lists), in FIFO order of
# at most _FOREIGN_KERNEL_LIMIT.
_foreign_kernels: dict = {}
_FOREIGN_KERNEL_LIMIT = 8


def _as_kernel(cqt_kernel) -> CqtKernel:
    """Accept a :class:`CqtKernel`, a scipy sparse matrix, a dense array or
    anything with ``toarray()`` (``zaftpu``'s ``CqtKernel`` included).

    A foreign kernel needs a finalize (an ``fft_length``-point host FFT per
    row, about a second at the reference geometry), so the result is
    memoised. Evicting a foreign kernel also drops its device operators.
    """
    if isinstance(cqt_kernel, CqtKernel):
        return cqt_kernel
    dense = np.asarray(cqt_kernel.toarray()
                       if hasattr(cqt_kernel, "toarray") else cqt_kernel)
    key = ("ref", id(cqt_kernel))
    try:
        # The callback binds the dicts so that it still works while the
        # interpreter shuts down and module globals are cleared.
        ref = weakref.ref(
            cqt_kernel,
            lambda _, k=key, f=_foreign_kernels, d=_device_kernels:
            _drop_kernel(k, f, d))
    except TypeError:  # no weak reference to it
        key, ref = ("content", hashlib.md5(dense.tobytes()).hexdigest()), None
    hit = _foreign_kernels.get(key)
    if hit is not None and (ref is None or hit[0]() is cqt_kernel):
        return hit[1]
    finalized = _finalize_kernel(dense)
    _foreign_kernels[key] = (ref, finalized)
    while len(_foreign_kernels) > _FOREIGN_KERNEL_LIMIT:
        _evict_kernel(next(iter(_foreign_kernels)))
    return finalized


def _drop_kernel(key, foreign: dict, device: dict) -> None:
    entry = foreign.pop(key, None)
    if entry is not None:
        kern_id = id(entry[1])
        for dkey in [k for k in device if k[0] == kern_id]:
            device.pop(dkey, None)


def _evict_kernel(key) -> None:
    """Forget one foreign kernel and only its own device operators."""
    _drop_kernel(key, _foreign_kernels, _device_kernels)


def _block_frames() -> int:
    """Frames per block of the float64 path: bounds its frames and spectra
    at about ``2 * block * fft_length * 8`` bytes (0.5 GB at 1024 and the
    reference geometry). ``ZAFTPU_CQT_BLOCK`` overrides it, read per call."""
    env = os.environ.get("ZAFTPU_CQT_BLOCK")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return 1024


# Device operators, keyed by (id(kernel), device, dtype); each entry pins
# its kernel so the id stays its own. FIFO-bounded. A float32 entry is the
# (2, L, F_pad) time-domain stack, a bfloat16 one its (2, 2, L, F_pad)
# presplit, a float64 one the reduced spectral kernel with its gather
# columns and conjugation mask.
_device_kernels: dict = {}
_DEVICE_KERNEL_LIMIT = 16


def _device_entry(kern: CqtKernel, device: torch.device, dtype, build):
    key = (id(kern), device, dtype)
    hit = _device_kernels.get(key)
    if hit is None:
        hit = (kern, build())
        _device_kernels[key] = hit
        while len(_device_kernels) > _DEVICE_KERNEL_LIMIT:
            _device_kernels.pop(next(iter(_device_kernels)))
    return hit[1]


def _device_time_kernel(kern: CqtKernel, device: torch.device,
                        split4: bool = False):
    """The ``(2, L, F_pad)`` float32 time-domain operator on ``device``, or
    (``split4``) its ``(2, 2, L, F_pad)`` bf16 presplit."""
    if split4:
        return _device_entry(
            kern, device, torch.bfloat16,
            lambda: torch.from_numpy(_cqtslab.time_ops_split4(
                kern.time_kernel)).to(device=device, dtype=torch.bfloat16))
    return _device_entry(
        kern, device, torch.float32,
        lambda: torch.from_numpy(_cqtslab.time_ops(kern.time_kernel)).to(
            device))


def _device_oracle_kernel(kern: CqtKernel, device: torch.device):
    """The float64 path's ``(k_reduced, gather_cols, conj_mask)`` on
    ``device``: the non-zero columns, each column's bin in the rfft half
    spectrum, and which of them are negative frequencies."""
    def build():
        length = kern.fft_length
        k_reduced = np.concatenate([kern.reduced_low, kern.reduced_high],
                                   axis=1)
        cols = np.concatenate([kern.columns_low, kern.columns_high])
        gather = np.where(cols <= length // 2, cols, length - cols)
        return (torch.from_numpy(k_reduced).to(device),
                torch.from_numpy(gather.astype(np.int64)).to(device),
                torch.from_numpy(cols > length // 2).to(device))

    return _device_entry(kern, device, torch.float64, build)


def _cqt_apply(padded: torch.Tensor, k_reduced, gather_cols, conj_mask,
               step: int, fft_length: int, number_times: int,
               block_frames: int) -> torch.Tensor:
    """Float64 magnitude CQT ``(..., T, F)`` of a padded signal, in blocks
    of frames: batched rfft, gather of the non-zero columns (conjugated
    where negative), complex GEMM, ``abs``."""
    out = []
    for b0 in range(0, number_times, block_frames):
        nb = min(block_frames, number_times - b0)
        seg = padded[..., b0 * step:(b0 + nb - 1) * step + fft_length]
        half = torch.fft.rfft(seg.unfold(-1, fft_length, step), dim=-1)
        gathered = half[..., gather_cols]
        gathered = torch.where(conj_mask, gathered.conj_physical(), gathered)
        out.append(torch.matmul(gathered, k_reduced.T).abs())
    return torch.cat(out, dim=-2)


def _octave_fold(spec: torch.Tensor, octave_resolution: int) -> torch.Tensor:
    """chroma[i] = sum_k spec[..., i + k*OR, :] (reference zaf.py:693-698):
    a zero pad to whole octaves, a reshape and a sum."""
    *lead, f, t = spec.shape
    octaves = -(-f // octave_resolution)
    padded = torch.nn.functional.pad(
        spec, (0, 0, 0, octaves * octave_resolution - f))
    return padded.reshape(*lead, octaves, octave_resolution, t).sum(dim=-3)


def _resolve_cqt_args(sampling_frequency, time_resolution, cqt_kernel,
                      config):
    """(sr, time resolution, kernel) from the positional arguments or a
    :class:`zaftpu_torch.config.CqtConfig` (whose :meth:`kernel` is
    cached), never both."""
    if config is not None:
        if (sampling_frequency is not None or time_resolution is not None
                or cqt_kernel is not None):
            raise ValueError(
                "pass either (sampling_frequency, time_resolution, "
                "cqt_kernel) or config=, not both")
        return (config.sampling_frequency, config.time_resolution,
                config.kernel())
    if (sampling_frequency is None or time_resolution is None
            or cqt_kernel is None):
        raise ValueError(
            "sampling_frequency, time_resolution and cqt_kernel are "
            "required when no config= is given")
    return sampling_frequency, time_resolution, cqt_kernel


def _cqt_inputs(audio_signal, sampling_frequency, time_resolution):
    """The validated signal (at least float32, a bfloat16 one promoted; a
    CUDA signal only as float32 after that), the hop and the frame count
    (zaf.py:600-612)."""
    x = _validate.check_signal(_as_input(audio_signal))
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    if x.is_cuda:
        check_cuda_dial()
        if x.dtype != torch.float32:
            raise NotImplementedError(
                f"the CUDA CQT takes float32 signals, got {x.dtype}")
    step = round(float(sampling_frequency) / float(time_resolution))
    number_times = int(x.shape[-1] // step)
    if number_times < 1:
        raise ValueError(
            f"signal too short: {x.shape[-1]} samples is less than one CQT "
            f"hop ({step} samples at time_resolution={time_resolution})")
    return x, step, number_times


def _slab_scheme_split4() -> bool:
    """Is the 4-pass bf16-split scheme selected for the CQT kernel?
    ``ZAFTPU_CQT_SCHEME`` (``zaftpu``'s ``_slab_scheme_split4``):

    * ``auto`` (default): split4, unless ``ZAFTPU_PRECISION`` is set to
      something else (an unset dial is its ``highest`` default, not a
      choice);
    * ``split4`` / ``exact``: force the scheme / follow the dial.
    """
    scheme = os.environ.get("ZAFTPU_CQT_SCHEME", "auto")
    if scheme == "split4":
        return True
    if scheme == "exact":
        return split4_enabled()
    explicit = os.environ.get("ZAFTPU_PRECISION")
    return explicit is None or explicit.lower() == "split4"


def _cqt_dispatch(x: torch.Tensor, kern: CqtKernel, step: int,
                  number_times: int, octave_resolution: int):
    """The asymmetric centring pad (zaf.py:613-620) plus the slab loop's
    tail (``zaftpu``'s ``_blocked_needed``), then the float32 or float64
    core; ``(..., F, T)`` as a transposed view, octave-folded when
    ``octave_resolution`` is set. A CUDA float32 signal takes the split4
    twin when the scheme selects it (``zaftpu``'s ``_use_slab_kernel`` on
    its accelerator); a CPU signal keeps the exact slab loop, as
    ``zaftpu``'s CPU backend does."""
    length = kern.fft_length
    pad_front = int(np.ceil((length - step) / 2))
    pad_back = int(np.floor((length - step) / 2))
    needed = _cqtslab.slab_needed(number_times, step, length)
    have = x.shape[-1] + pad_front + pad_back
    padded = torch.nn.functional.pad(
        x, (pad_front, pad_back + max(0, needed - have)))
    if x.dtype == torch.float32:
        split4 = x.is_cuda and _slab_scheme_split4()
        core = (_cqtslab.cqt_magnitudes_split4 if split4
                else _cqtslab.cqt_magnitudes)
        mags = core(padded, _device_time_kernel(kern, x.device, split4),
                    step, length, number_times, kern.number_frequencies)
    else:
        k_reduced, gather_cols, conj_mask = _device_oracle_kernel(kern,
                                                                  x.device)
        mags = _cqt_apply(padded, k_reduced, gather_cols, conj_mask, step,
                          length, number_times, _block_frames())
    spec = mags.transpose(-1, -2)
    if octave_resolution:
        return _octave_fold(spec, octave_resolution)
    return spec


def cqtspectrogram(audio_signal, sampling_frequency=None,
                   time_resolution=None, cqt_kernel=None, *, config=None):
    """Magnitude CQT spectrogram ``(..., number_frequencies, number_times)``.

    Reference semantics (zaf.py:562-635): ``step = round(sr/time_res)``,
    ``T = floor(N/step)``, an asymmetric centring pad, per-frame
    ``|K . fft(frame)|``. ``config=CqtConfig(...)`` may stand in for the
    three positional parameters. The output is a transposed view of a
    frames-major tensor. A CUDA float32 signal runs the CQT kernel of
    ``ZAFTPU_CQT_SCHEME``: the split4 twin by default.
    """
    sampling_frequency, time_resolution, cqt_kernel = _resolve_cqt_args(
        sampling_frequency, time_resolution, cqt_kernel, config)
    kern = _as_kernel(cqt_kernel)
    x, step, number_times = _cqt_inputs(audio_signal, sampling_frequency,
                                        time_resolution)
    return _cqt_dispatch(x, kern, step, number_times, octave_resolution=0)


def cqtchromagram(audio_signal, sampling_frequency=None, time_resolution=None,
                  octave_resolution=None, cqt_kernel=None, *, config=None):
    """CQT chromagram ``(..., octave_resolution, number_times)``: chroma
    ``i`` sums channels ``i, i+OR, i+2*OR, ...`` of the CQT spectrogram
    (reference zaf.py:638-700). ``config=CqtConfig(...)`` may stand in for
    the positional parameters.
    """
    if config is not None and octave_resolution is None:
        octave_resolution = config.octave_resolution
    sampling_frequency, time_resolution, cqt_kernel = _resolve_cqt_args(
        sampling_frequency, time_resolution, cqt_kernel, config)
    if octave_resolution is None:
        raise ValueError(
            "octave_resolution is required when no config= is given")
    kern = _as_kernel(cqt_kernel)
    x, step, number_times = _cqt_inputs(audio_signal, sampling_frequency,
                                        time_resolution)
    return _cqt_dispatch(x, kern, step, number_times, int(octave_resolution))
