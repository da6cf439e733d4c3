"""Mel filterbank, mel spectrogram and MFCCs.

The filterbank is built on the host in numpy float64 with the reference's
construction math (zaf.py:279-321), the same as ``zaftpu.features.mel``, so
the two packages' filterbanks are bit-identical; it is kept dense. MFCC's
orthonormal DCT-II over the mel axis (the reference's
``scipy.fftpack.dct(axis=0, norm="ortho")``, zaf.py:443-449) is a host
matrix too.

On a CUDA float32 signal ``melspectrogram`` and ``mfcc`` take the
real-FFT kernel's mel store (framing, FFT, magnitude or power, and the
filterbank's nonzeros from a CSR table; :mod:`zaftpu_torch.kernels.melfft`)
where its shape rule holds, on both dials, and the one-pass mel GEMM kernel
(:mod:`zaftpu_torch.kernels.melfused`) at any other window on the exact
dial, the half spectrum, ``|·|`` and the filterbank GEMM under split4
(:func:`zaftpu_torch.kernels.melfused.route`); ``ZAFTPU_MELFUSE=1`` forces
the GEMM kernel off the rule and ``ZAFTPU_MELFUSE=0`` the half spectrum
everywhere. The log and the DCT-II GEMM run outside any kernel, as in
``zaftpu``. On the CPU the same paths run the kernels' plain versions, in
the input's dtype.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch import kernels as _kernels
from zaftpu_torch.core import validate as _validate
from zaftpu_torch.core.fft import device_operator
from zaftpu_torch.core import policy as _policy
from zaftpu_torch.core.policy import exact_matmul
from zaftpu_torch.kernels import melfft as _melfft
from zaftpu_torch.kernels import melfused as _melfused
from zaftpu_torch.transforms.stft import _analysis_inputs, centre_padded

# np.finfo(float).eps, as the reference adds at zaf.py:445 whatever the
# compute dtype.
_LOG_EPS = float(np.finfo(np.float64).eps)


def hertz_to_mel(frequency):
    """``mel(f) = 2595*log10(1 + f/700)`` (reference zaf.py:280-281)."""
    return 2595.0 * np.log10(1.0 + np.asarray(frequency, dtype=np.float64)
                             / 700.0)


def mel_to_hertz(mel):
    """Inverse mel scale ``700*(10^(m/2595) - 1)`` (reference
    zaf.py:291-294)."""
    return 700.0 * (np.power(10.0, np.asarray(mel, dtype=np.float64)
                             / 2595.0) - 1.0)


@lru_cache(maxsize=64)
def _melfilterbank_cached(sampling_frequency: int, window_length: int,
                          number_mels: int) -> np.ndarray:
    # Mel range: from one FFT bin (sr/WL, not 0 Hz; zaf.py:280) to Nyquist.
    mel_lo = hertz_to_mel(sampling_frequency / window_length)
    mel_hi = hertz_to_mel(sampling_frequency / 2)
    # Half-overlapping triangles of constant mel width 2*(hi-lo)/(M+1)
    # (zaf.py:284-287), edges rounded to integer FFT bins before the ramps
    # are built (zaf.py:290-295).
    width = 2.0 * (mel_hi - mel_lo) / (number_mels + 1)
    edges_mel = np.arange(mel_lo, mel_hi + 1, width / 2.0)
    edges = np.round(
        mel_to_hertz(edges_mel) * window_length / sampling_frequency
    ).astype(int)

    fbank = np.zeros((number_mels, window_length // 2), dtype=np.float64)
    for m in range(number_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        # Ascending then descending ramps over bin ranges [lo-1, mid) and
        # [mid-1, hi): the -1 offsets and the mid-1 overwrite reproduce the
        # reference's construction exactly (zaf.py:301-316).
        fbank[m, lo - 1:mid] = np.linspace(0.0, 1.0, num=mid - lo + 1)
        fbank[m, mid - 1:hi] = np.linspace(1.0, 0.0, num=hi - mid + 1)
    return fbank


def melfilterbank(sampling_frequency, window_length, number_mels):
    """Mel filterbank as a dense float64 ``(number_mels, window_length/2)``
    host array over FFT bins 1..WL/2 (DC dropped, Nyquist kept; zaf.py:370),
    bit-identical to the reference's ``melfilterbank(...).toarray()``
    (zaf.py:246-321). Cached per parameter tuple."""
    return _melfilterbank_cached(int(sampling_frequency), int(window_length),
                                 int(number_mels))


@lru_cache(maxsize=16)
def dct_ii_ortho_matrix(size: int) -> np.ndarray:
    """Orthonormal DCT-II matrix ``C[k,n] = s_k sqrt(2/N) cos(pi k(2n+1)/2N)``,
    equal to ``scipy.fftpack.dct(eye(N), norm='ortho')`` (the MFCC cepstral
    transform, zaf.py:443-449)."""
    n = np.arange(size, dtype=np.float64)
    k = n[:, None]
    mat = np.sqrt(2.0 / size) * np.cos(np.pi * k * (2.0 * n[None, :] + 1.0)
                                       / (2.0 * size))
    mat[0] /= np.sqrt(2.0)
    return mat


def _operator_dtype(dtype: torch.dtype, power: bool) -> torch.dtype:
    """The filterbank's dtype for a ``dtype`` signal: ``mfcc`` (``power``)
    and ``melspectrogram`` are in ``policy.BF16_EXEMPT``, so the bf16
    compute dtype leaves it ``dtype``, as ``zaftpu``'s mel.py:196, 250."""
    return _policy.operator_dtype(dtype, "mfcc" if power else
                                  "melspectrogram")


def _mel_rows(x, window, fbank, step, power):
    """Mel (``power=False``) or power-mel rows ``(..., T, n_mels)`` of the
    dense host filterbank ``fbank`` (:func:`mel_rows_padded` of the
    centre-padded signal)."""
    # A new table's copy from host memory waits for the queued kernels, so
    # it goes before the pad is queued.
    table = filterbank_table(x, window, fbank, power)
    padded, t = centre_padded(x, window.shape[0], step)
    return mel_rows_padded(padded, window, fbank, step, t, power, table)


def filterbank_table(x, window, fbank, power):
    """The filterbank's device table for the mel store when
    :func:`mel_rows_padded` takes it for signal ``x``, else None."""
    if _melfused.route(x.dtype, window.shape[0]) != "fft":
        return None
    return _melfft.filterbank_device_table(fbank, x.device,
                                           _operator_dtype(x.dtype, power))


def mel_rows_padded(padded, window, fbank, step, number_times, power,
                    table=None):
    """Mel or power-mel rows ``(..., T, n_mels)`` of the first
    ``number_times`` frames of an already padded signal: the real-FFT
    kernel's mel store, the one-pass mel kernel, or the split path
    (zaftpu's mel.py:146-148, 209-212), as
    :func:`zaftpu_torch.kernels.melfused.route` says (the streaming
    pipeline's block body too). ``table``: the filterbank's device table
    for the mel store, if the caller has fetched it."""
    wl, t = window.shape[0], number_times
    route = _melfused.route(padded.dtype, wl)
    op_dtype = _operator_dtype(padded.dtype, power)
    if route == "fft":
        if table is None:
            table = _melfft.filterbank_device_table(fbank, padded.device,
                                                    op_dtype)
        return _melfft.mel_rows_fft(padded, window, table, wl, step, t,
                                    power)
    fbank_t = _filterbank_t(fbank, padded, op_dtype)
    if route == "kernel":
        return _melfused.mel_rows(padded, window, fbank_t, wl, step, t,
                                  power)
    mag = _kernels.windowed_frames_rfft(padded, window, wl, step,
                                        t)[..., 1:].abs()
    return exact_matmul(mag * mag if power else mag, fbank_t)


def cepstra(power_mel: torch.Tensor, number_mels: int,
            number_coefficients: int) -> torch.Tensor:
    """MFCC rows ``(..., T, C)`` from power-mel rows: ``log(+eps)``, the
    orthonormal DCT-II along the mel axis, coefficients 1..C."""
    logmel = torch.log(power_mel + _LOG_EPS)
    dct = device_operator(dct_ii_ortho_matrix, (number_mels,),
                          power_mel.device,
                          _operator_dtype(power_mel.dtype, True))
    # Keep coefficients 1..C; the 0th is dropped (zaf.py:452).
    return exact_matmul(logmel, dct.T)[..., 1:number_coefficients + 1]


def check_coefficients(number_coefficients, number_mels: int) -> int:
    """The MFCC count as an int in ``[1, number_mels - 1]``, else
    ``ValueError``."""
    if number_coefficients is None:
        raise ValueError(
            "number_coefficients is required when no config= is given")
    number_coefficients = int(number_coefficients)
    if not 1 <= number_coefficients < number_mels:
        raise ValueError(
            f"number_coefficients must be in [1, number_mels-1="
            f"{number_mels - 1}] (the 0th coefficient is dropped, "
            f"zaf.py:452), got {number_coefficients}")
    return number_coefficients


def _resolve_mel_args(window_function, step_length, mel_filterbank, config):
    """(window, step, filterbank) from the positional arguments or a
    :class:`zaftpu_torch.config.MelConfig`, never both."""
    if config is not None:
        if (window_function is not None or step_length is not None
                or mel_filterbank is not None):
            raise ValueError(
                "pass either (window_function, step_length, mel_filterbank) "
                "or config=, not both")
        return config.window_array(), config.step_length, config.filterbank()
    if window_function is None or step_length is None or mel_filterbank is None:
        raise ValueError(
            "window_function, step_length and mel_filterbank are required "
            "when no config= is given")
    return window_function, step_length, mel_filterbank


def _inputs(audio_signal, window_function, step_length, mel_filterbank,
            config):
    """The validated signal, window, hop and dense filterbank."""
    window, step, fbank = _resolve_mel_args(window_function, step_length,
                                            mel_filterbank, config)
    x, win, step = _analysis_inputs(audio_signal, window, step, None)
    fbank = _validate.check_filterbank(_melfft.as_dense(fbank),
                                      win.shape[0])
    return x, win, step, fbank


def _filterbank_t(fbank: np.ndarray, x: torch.Tensor,
                  dtype: torch.dtype | None = None) -> torch.Tensor:
    """The ``(WL/2, n_mels)`` filterbank transpose on ``x``'s device in
    ``dtype`` (``x``'s by default)."""
    return torch.from_numpy(np.ascontiguousarray(fbank.T)).to(
        device=x.device, dtype=dtype or x.dtype)


def melspectrogram(audio_signal, window_function=None, step_length=None,
                   mel_filterbank=None, *, config=None) -> torch.Tensor:
    """Mel spectrogram ``(..., number_mels, number_times)``: the magnitude
    spectrogram times the filterbank (reference zaf.py:324-375).
    ``mel_filterbank`` may be the dense array from :func:`melfilterbank`, a
    tensor or a scipy sparse matrix; alternatively ``config=MelConfig(...)``
    gives all three parameters."""
    x, win, step, fbank = _inputs(audio_signal, window_function, step_length,
                                  mel_filterbank, config)
    mel = _mel_rows(x, win, fbank, step, power=False)
    return mel.transpose(-1, -2)


def mfcc(audio_signal, window_function=None, step_length=None,
         mel_filterbank=None, number_coefficients=None, *,
         config=None) -> torch.Tensor:
    """MFCCs ``(..., number_coefficients, number_times)`` (reference
    zaf.py:378-454): power spectrogram, filterbank, ``log(+eps)``,
    orthonormal DCT-II along the mel axis, coefficients 1..C.
    Alternatively ``config=MelConfig(...)`` gives every parameter."""
    if config is not None and number_coefficients is None:
        number_coefficients = config.number_coefficients
    x, win, step, fbank = _inputs(audio_signal, window_function, step_length,
                                  mel_filterbank, config)
    number_coefficients = check_coefficients(number_coefficients,
                                             fbank.shape[0])
    mel = _mel_rows(x, win, fbank, step, power=True)
    return cepstra(mel, fbank.shape[0],
                   number_coefficients).transpose(-1, -2)
