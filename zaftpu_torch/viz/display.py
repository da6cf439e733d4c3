"""Display helpers (host-side, matplotlib), the port of
``zaftpu.viz.display`` (reference zaf.py:1222-1484).

The six ``*show`` / ``sigplot`` helpers place the reference's axes, ticks
and labels. They take NumPy arrays or tensors on any device, fetched to the
host with :func:`zaftpu_torch.asnumpy` (a bfloat16 tensor as float32). As
in ``zaftpu``, the dB conversions clamp at a floor (``amin``) before
``20*log10``, where the reference applies none (zaf.py:1303,1360,1445) and
silent bins read ``-inf``; values above the floor are identical. Pass
``floor=None`` to a dB display (or ``amin=None`` to
:func:`amplitude_to_db`) for the reference's ``-inf`` bins.

matplotlib is imported lazily, so compute-only deployments never load (or
need) it.
"""

from __future__ import annotations

import numpy as np

from zaftpu_torch.utils.fetch import asnumpy

_DB_FLOOR_AMIN = 1e-30


def _plt():
    import matplotlib
    if matplotlib.get_backend().lower() not in (
            "agg", "module://matplotlib_inline.backend_inline"):
        matplotlib.use("Agg", force=False)  # force=False: never raises
    import matplotlib.pyplot as plt
    return plt


def amplitude_to_db(magnitude, amin=_DB_FLOOR_AMIN) -> np.ndarray:
    """``20*log10(max(|x|, amin))`` on the host (reference zaf.py:1303 with
    a floor).

    ``amin=None`` drops the floor: zero bins give ``-inf``, as at
    zaf.py:1303,1360,1445 (NumPy warns of the divide by zero, as the
    reference does)."""
    magnitude = asnumpy(magnitude)
    if amin is not None:
        magnitude = np.maximum(magnitude, amin)
    return 20.0 * np.log10(magnitude)


def sigplot(audio_signal, sampling_frequency, xtick_step=1):
    """Plot a signal with a seconds x-axis (reference zaf.py:1222-1253)."""
    plt = _plt()
    audio_signal = asnumpy(audio_signal)
    number_samples = audio_signal.shape[0]
    locations = np.arange(xtick_step * sampling_frequency, number_samples,
                          xtick_step * sampling_frequency)
    labels = np.arange(xtick_step, number_samples / sampling_frequency,
                       xtick_step).astype(int)
    plt.plot(audio_signal)
    plt.autoscale(tight=True)
    plt.xticks(ticks=locations, labels=labels)
    plt.xlabel("Time (s)")


def _time_ticks(number_times, time_resolution, xtick_step):
    locations = np.arange(xtick_step * time_resolution, number_times,
                          xtick_step * time_resolution)
    labels = np.arange(xtick_step, number_times / time_resolution,
                       xtick_step).astype(int)
    return locations, labels


def specshow(audio_spectrogram, number_samples, sampling_frequency,
             xtick_step=1, ytick_step=1000, floor=_DB_FLOOR_AMIN):
    """Spectrogram in dB / seconds / Hz (reference zaf.py:1256-1308).

    ``floor=None`` gives the reference's unclamped ``20*log10``
    (zaf.py:1303): silent bins map to ``-inf``."""
    plt = _plt()
    audio_spectrogram = asnumpy(audio_spectrogram)
    number_frequencies, number_times = audio_spectrogram.shape
    number_seconds = number_samples / sampling_frequency
    time_resolution = number_times / number_seconds
    frequency_resolution = number_frequencies / (sampling_frequency / 2)
    xlocs, xlabels = _time_ticks(number_times, time_resolution, xtick_step)
    ylocs = np.arange(ytick_step * frequency_resolution, number_frequencies,
                      ytick_step * frequency_resolution)
    ylabels = np.arange(ytick_step, sampling_frequency / 2,
                        ytick_step).astype(int)
    plt.imshow(amplitude_to_db(audio_spectrogram, floor), aspect="auto",
               cmap="jet", origin="lower")
    plt.xticks(ticks=xlocs, labels=xlabels)
    plt.yticks(ticks=ylocs, labels=ylabels)
    plt.xlabel("Time (s)")
    plt.ylabel("Frequency (Hz)")


def melspecshow(mel_spectrogram, number_samples, sampling_frequency,
                window_length, xtick_step=1, floor=_DB_FLOOR_AMIN):
    """Mel spectrogram in dB with mel -> Hz y-ticks (reference
    zaf.py:1311-1365).

    ``floor=None`` gives the reference's unclamped ``20*log10``
    (zaf.py:1360)."""
    plt = _plt()
    from zaftpu_torch.features.mel import hertz_to_mel, mel_to_hertz
    mel_spectrogram = asnumpy(mel_spectrogram)
    number_mels, number_times = mel_spectrogram.shape
    number_seconds = number_samples / sampling_frequency
    time_resolution = number_times / number_seconds
    mel_scale = np.linspace(hertz_to_mel(sampling_frequency / window_length),
                            hertz_to_mel(sampling_frequency / 2), number_mels)
    hertz_scale = mel_to_hertz(mel_scale)
    xlocs, xlabels = _time_ticks(number_times, time_resolution, xtick_step)
    plt.imshow(amplitude_to_db(mel_spectrogram, floor), aspect="auto",
               cmap="jet", origin="lower")
    plt.xticks(ticks=xlocs, labels=xlabels)
    plt.yticks(ticks=np.arange(0, number_mels, 8),
               labels=hertz_scale[::8].astype(int))
    plt.xlabel("Time (s)")
    plt.ylabel("Frequency (Hz)")


def mfccshow(audio_mfcc, number_samples, sampling_frequency, xtick_step=1):
    """MFCC matrix (linear scale) in seconds (reference zaf.py:1368-1403)."""
    plt = _plt()
    audio_mfcc = asnumpy(audio_mfcc)
    number_times = audio_mfcc.shape[1]
    time_resolution = number_times / (number_samples / sampling_frequency)
    xlocs, xlabels = _time_ticks(number_times, time_resolution, xtick_step)
    plt.imshow(audio_mfcc, aspect="auto", cmap="jet", origin="lower")
    plt.xticks(ticks=xlocs, labels=xlabels)
    plt.xlabel("Time (s)")
    plt.ylabel("Coefficients")


def cqtspecshow(cqt_spectrogram, time_resolution, octave_resolution,
                minimum_frequency, xtick_step=1, floor=_DB_FLOOR_AMIN):
    """CQT spectrogram in dB with log-Hz y-ticks (reference
    zaf.py:1406-1450).

    ``floor=None`` gives the reference's unclamped ``20*log10``
    (zaf.py:1445)."""
    plt = _plt()
    cqt_spectrogram = asnumpy(cqt_spectrogram)
    number_frequencies, number_times = cqt_spectrogram.shape
    xlocs, xlabels = _time_ticks(number_times, time_resolution, xtick_step)
    ylocs = np.arange(0, number_frequencies, octave_resolution)
    ylabels = (minimum_frequency
               * 2.0 ** (ylocs / octave_resolution)).astype(int)
    plt.imshow(amplitude_to_db(cqt_spectrogram, floor), aspect="auto",
               cmap="jet", origin="lower")
    plt.xticks(ticks=xlocs, labels=xlabels)
    plt.yticks(ticks=ylocs, labels=ylabels)
    plt.xlabel("Time (s)")
    plt.ylabel("Frequency (Hz)")


def cqtchromshow(cqt_chromagram, time_resolution, xtick_step=1):
    """CQT chromagram (linear scale) in seconds (reference
    zaf.py:1453-1484)."""
    plt = _plt()
    cqt_chromagram = asnumpy(cqt_chromagram)
    number_times = cqt_chromagram.shape[1]
    xlocs, xlabels = _time_ticks(number_times, time_resolution, xtick_step)
    plt.imshow(cqt_chromagram, aspect="auto", cmap="jet", origin="lower")
    plt.xticks(ticks=xlocs, labels=xlabels)
    plt.xlabel("Time (s)")
    plt.ylabel("Chroma")
