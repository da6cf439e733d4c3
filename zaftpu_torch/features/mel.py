"""Mel filterbank, mel spectrogram and MFCCs.

The filterbank is built on the host in numpy float64 with the reference's
construction math (zaf.py:279-321), the same as ``zaftpu.features.mel``, so
the two packages' filterbanks are bit-identical; it is kept dense. MFCC's
orthonormal DCT-II over the mel axis (the reference's
``scipy.fftpack.dct(axis=0, norm="ortho")``, zaf.py:443-449) is a host
matrix too.

On a CUDA float32 signal ``melspectrogram`` and ``mfcc`` take the half
spectrum from the analysis dispatch, ``|·|`` and the filterbank GEMM at a
power-of-two window (the real-FFT kernel's), and the one-pass mel kernel
(framing, rDFT, magnitude or power, filterbank GEMM;
:mod:`zaftpu_torch.kernels.melfused`) at any other; ``ZAFTPU_MELFUSE=1``
forces the kernel and ``ZAFTPU_MELFUSE=0`` the half spectrum. The
log and the DCT-II GEMM run outside any kernel, as in ``zaftpu``. On the
CPU the same paths run the kernels' plain versions, in the input's dtype.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from zaftpu_torch.core import validate as _validate
from zaftpu_torch.core.fft import device_operator
from zaftpu_torch.core.policy import exact_matmul
from zaftpu_torch.kernels import melfused as _melfused
from zaftpu_torch.transforms.stft import (_analysis_inputs, _stft_frames_half,
                                          centre_padded)

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


def _as_dense(mel_filterbank) -> np.ndarray:
    """A dense host array from a dense array, a tensor or any scipy.sparse
    matrix."""
    if hasattr(mel_filterbank, "toarray"):
        return np.asarray(mel_filterbank.toarray())
    if isinstance(mel_filterbank, torch.Tensor):
        return mel_filterbank.detach().cpu().numpy()
    return np.asarray(mel_filterbank)


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


def mel_rows_fused_or_none(x: torch.Tensor, window: torch.Tensor,
                           fbank_t: torch.Tensor, step: int,
                           power: bool) -> torch.Tensor | None:
    """The one-pass mel kernel's ``(..., T, n_mels)`` rows when
    :func:`zaftpu_torch.kernels.melfused.kernel_wanted`; ``None`` selects
    the split half-spectrum path. ``x`` and ``window`` as
    :func:`zaftpu_torch.transforms.stft._analysis_inputs` gives them."""
    wl = window.shape[0]
    if not _melfused.kernel_wanted(x.dtype, wl):
        return None
    padded, t = centre_padded(x, wl, step)
    return _melfused.mel_rows(padded, window, fbank_t, wl, step, t, power)


def _mel_rows(x, window, fbank_t, step, power):
    """Mel (``power=False``) or power-mel rows ``(..., T, n_mels)``: the
    one-pass kernel, or the split path (zaftpu's mel.py:146-148, 209-212)."""
    rows = mel_rows_fused_or_none(x, window, fbank_t, step, power)
    if rows is not None:
        return rows
    mag = _stft_frames_half(x, window, step)[..., 1:].abs()
    return exact_matmul(mag * mag if power else mag, fbank_t)


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
    fbank = _validate.check_filterbank(_as_dense(fbank), win.shape[0])
    return x, win, step, fbank


def _filterbank_t(fbank: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """The ``(WL/2, n_mels)`` filterbank transpose on ``x``'s device in its
    dtype."""
    return torch.from_numpy(np.ascontiguousarray(fbank.T)).to(
        device=x.device, dtype=x.dtype)


def melspectrogram(audio_signal, window_function=None, step_length=None,
                   mel_filterbank=None, *, config=None) -> torch.Tensor:
    """Mel spectrogram ``(..., number_mels, number_times)``: the magnitude
    spectrogram times the filterbank (reference zaf.py:324-375).
    ``mel_filterbank`` may be the dense array from :func:`melfilterbank`, a
    tensor or a scipy sparse matrix; alternatively ``config=MelConfig(...)``
    gives all three parameters."""
    x, win, step, fbank = _inputs(audio_signal, window_function, step_length,
                                  mel_filterbank, config)
    mel = _mel_rows(x, win, _filterbank_t(fbank, x), step, power=False)
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
    if number_coefficients is None:
        raise ValueError(
            "number_coefficients is required when no config= is given")
    number_coefficients = int(number_coefficients)
    if not 1 <= number_coefficients < fbank.shape[0]:
        raise ValueError(
            f"number_coefficients must be in [1, number_mels-1="
            f"{fbank.shape[0] - 1}] (the 0th coefficient is dropped, "
            f"zaf.py:452), got {number_coefficients}")
    mel = _mel_rows(x, win, _filterbank_t(fbank, x), step, power=True)
    logmel = torch.log(mel + _LOG_EPS)
    dct = device_operator(dct_ii_ortho_matrix, (fbank.shape[0],), x.device,
                          x.dtype)
    cepstra = exact_matmul(logmel, dct.T)
    # Keep coefficients 1..C; the 0th is dropped (zaf.py:452).
    return cepstra[..., 1:number_coefficients + 1].transpose(-1, -2)
