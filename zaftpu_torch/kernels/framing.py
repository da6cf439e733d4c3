"""Frame + window: CUDA kernel (``csrc/framing.cu``) and its plain version.

Replaces ``zaftpu/pallas/framing.py: frame_window``. The kernel is
memory-bound (one multiply per frame sample); see the source note in
``csrc/framing.cu`` for its design. Both versions do the same single f32
multiply, so they agree bit for bit.
"""

from __future__ import annotations

import torch

from zaftpu_torch.core.frame import extract_frames
from zaftpu_torch.kernels import _build

CUDA_SOURCE = "zaftpu_torch/csrc/framing.cu"
REPLACES = "zaftpu/pallas/framing.py:57"  # frame_window


def frame_window_plain(padded: torch.Tensor, window: torch.Tensor,
                       window_length: int, step: int,
                       number_times: int) -> torch.Tensor:
    """Windowed frames ``(..., T, WL)`` in plain PyTorch."""
    frame_window_plain.calls += 1
    frames = extract_frames(padded, window_length, step, number_times)
    return frames * window.to(frames.dtype)


frame_window_plain.calls = 0


def frame_window(padded: torch.Tensor, window: torch.Tensor,
                 window_length: int, step: int,
                 number_times: int) -> torch.Tensor:
    """Windowed overlapped frames ``(..., number_times, window_length)`` of
    a padded signal ``(..., L)``; frame ``t`` is samples
    ``[t*step, t*step + WL)`` times the window. Any ``step <= WL``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not padded.is_cuda:
        return frame_window_plain(padded, window, window_length, step,
                                  number_times)
    return _frame_window_cuda(padded, window, window_length, step,
                              number_times)


def check_frame_args(name: str, padded: torch.Tensor, window: torch.Tensor,
                     window_length: int, step: int,
                     number_times: int) -> None:
    """Raise unless the signal is float32 and holds ``number_times`` frames
    of a ``(window_length,)`` window at a hop in ``[1, window_length]``:
    what the framing and fused kernels read without bounds checks."""
    _build.require_f32(padded, name)
    wl, t = window_length, number_times
    length = padded.shape[-1]
    if not 1 <= step <= wl or window.shape != (wl,):
        raise ValueError(f"{name}: need step in [1, {wl}] and a ({wl},) "
                         f"window, got {step} and {tuple(window.shape)}")
    if length < (t - 1) * step + wl:
        raise ValueError(f"{name}: {length} samples hold fewer than {t} "
                         f"frames of {wl} at hop {step}")


def _frame_window_cuda(padded: torch.Tensor, window: torch.Tensor,
                       window_length: int, step: int,
                       number_times: int) -> torch.Tensor:
    """Check the CUDA input, launch the kernel, count the launch."""
    check_frame_args("frame_window", padded, window, window_length, step,
                     number_times)
    wl, t = window_length, number_times
    length = padded.shape[-1]
    lead = padded.shape[:-1]
    sig = padded.reshape(-1, length).contiguous()
    win = window.to(device=padded.device, dtype=torch.float32).contiguous()
    out = torch.empty((sig.shape[0], t, wl), dtype=torch.float32,
                      device=padded.device)
    err = _build.library().zt_frame_window(
        sig.data_ptr(), win.data_ptr(), out.data_ptr(), sig.shape[0],
        length, t, wl, step, _build.stream_of(padded))
    _build.check(err, "zt_frame_window")
    frame_window.launches += 1
    return out.reshape(*lead, t, wl)


frame_window.launches = 0
