"""WAV file I/O (the port of ``zaftpu.io.wav``).

Normalisation contract: integer samples are scaled by ``2^(8*itemsize - 1)``
on read (int16 -> [-1, 1)), as the reference does (zaf.py:1187-1219);
write passes data through unscaled, so float in -> float WAV out.

Deliberate divergence from the reference for float-format WAV files, as in
``zaftpu``: the reference divides every dtype by ``2^(8*itemsize - 1)``,
floats included (zaf.py:1202), which shrinks normalised float data and
breaks its own read(write(x)) round trip; here float samples pass through
unscaled.

The native C++ block codec (:mod:`zaftpu_torch.io.native`) backs
:func:`wavread_f32` and the streaming reader; this module is the portable
front end.
"""

from __future__ import annotations

import numpy as np
import scipy.io.wavfile


def wavread(audio_file):
    """Read a WAV file: ``(audio_signal, sampling_frequency)``, the signal
    float64 ``(number_samples, number_channels)`` (or ``(number_samples,)``
    for mono), integer formats normalised to [-1, 1)."""
    sampling_frequency, audio_signal = scipy.io.wavfile.read(audio_file)
    if np.issubdtype(audio_signal.dtype, np.integer):
        audio_signal = audio_signal / float(
            2 ** (audio_signal.itemsize * 8 - 1))
    else:
        audio_signal = audio_signal.astype(np.float64)
    return audio_signal, sampling_frequency


def wavwrite(audio_signal, sampling_frequency, audio_file):
    """Write a WAV file, unscaled (reference zaf.py:1207-1219). A tensor is
    copied to the host first."""
    if hasattr(audio_signal, "detach"):
        audio_signal = audio_signal.detach().cpu().numpy()
    scipy.io.wavfile.write(audio_file, int(sampling_frequency),
                           np.asarray(audio_signal))


def wavread_f32(audio_file):
    """Float32 read through the native codec (seeks, no whole-file float64
    conversion), SciPy when the codec is unavailable or cannot parse the
    file; the normalisation of :func:`wavread`. Returns ``(signal (N,
    channels) float32, sampling_frequency)``; raises
    :class:`FileNotFoundError` when the codec's source is missing."""
    from zaftpu_torch.io import native

    try:
        handle = native.WavFile(audio_file)
        return handle.read(), handle.sample_rate
    except (RuntimeError, ValueError):
        signal, sr = wavread(audio_file)
        return np.asarray(signal, dtype=np.float32), sr
