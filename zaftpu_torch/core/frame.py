"""Framing, padding and overlap-add primitives.

Host integer and float formulas identical to ``zaftpu.core.frame`` (the
reference's zaf.py:99-125 padding and zaf.py:241 COLA gain), and the plain
PyTorch framing and overlap-add that the kernels in
:mod:`zaftpu_torch.kernels` are held against.
"""

from __future__ import annotations

import numpy as np
import torch


def stft_padding(number_samples: int, window_length: int, step_length: int):
    """Centering pad lengths and frame count for STFT analysis.

    Reproduces reference zaf.py:99-125: pad ``floor(WL/2)`` zeros at the
    start; ``T = ceil(((N + 2*pad) - WL)/step) + 1``; end-pad so the padded
    length is exactly ``T*step + (WL - step)``.

    Returns ``(pad_front, pad_back, number_times)``.
    """
    pad_front = window_length // 2
    number_times = (
        int(np.ceil(((number_samples + 2 * pad_front) - window_length)
                    / step_length)) + 1
    )
    padded_length = number_times * step_length + (window_length - step_length)
    pad_back = padded_length - number_samples - pad_front
    return pad_front, pad_back, number_times


def extract_frames(padded: torch.Tensor, window_length: int, step_length: int,
                   number_times: int) -> torch.Tensor:
    """Overlapped frames ``(..., number_times, window_length)`` of a padded
    signal ``(..., L)``, ``L >= number_times*step + window_length - step``;
    frame ``j`` starts at sample ``j*step`` (zaf.py:131-136). Returned as a
    strided view (``unfold``); callers that need it dense copy it."""
    needed = number_times * step_length + (window_length - step_length)
    return padded[..., :needed].unfold(-1, window_length, step_length)


def overlap_add(frames: torch.Tensor, step_length: int) -> torch.Tensor:
    """Constant overlap-add of ``(..., T, WL)`` frames at hop ``step``.

    Output ``(..., T*step + WL - step)`` (zaf.py:227-233): the sum of the K
    = ceil(WL/step) chunk planes, c ascending and left-associated, each
    frame zero-padded to ``K*step`` samples where ``step`` does not divide
    ``WL``. That is the OLA kernel's order and, where ``step | WL``,
    ``zaftpu.core.frame.overlap_add``'s; no atomics, so the sum is the same
    from run to run on the card.
    """
    *lead, t, wl = frames.shape
    s = step_length
    k = -(-wl // s)
    if k * s != wl:
        frames = torch.nn.functional.pad(frames, (0, k * s - wl))
    chunks = frames.reshape(*lead, t, k, s)
    total = torch.nn.functional.pad(chunks[..., :, 0, :], (0, 0, 0, k - 1))
    for c in range(1, k):
        total = total + torch.nn.functional.pad(chunks[..., :, c, :],
                                                (0, 0, c, k - 1 - c))
    return total.reshape(*lead, (t + k - 1) * s)[..., :t * s + wl - s]


def cola_gain(window: np.ndarray, step_length: int) -> float:
    """COLA normalization gain ``sum(window[::step])`` (reference zaf.py:241),
    from a host array."""
    return float(np.asarray(window, dtype=np.float64)[::step_length].sum())
