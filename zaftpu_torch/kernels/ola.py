"""Overlap-add: CUDA kernel (``csrc/ola.cu``) and its plain version.

Replaces ``zaftpu/pallas/ola.py: overlap_add``. The kernel is memory-bound;
see the source note in ``csrc/ola.cu``. For ``step | WL`` both versions sum
the same terms in the same order (c ascending, left-associated), so they
agree bit for bit.
"""

from __future__ import annotations

import torch

from zaftpu_torch.core import frame as _frame
from zaftpu_torch.kernels import _build

CUDA_SOURCE = "zaftpu_torch/csrc/ola.cu"
REPLACES = "zaftpu/pallas/ola.py:104"  # overlap_add


def overlap_add_plain(frames: torch.Tensor, step: int) -> torch.Tensor:
    """Overlap-add in plain PyTorch (:func:`zaftpu_torch.core.frame.
    overlap_add`)."""
    overlap_add_plain.calls += 1
    return _frame.overlap_add(frames, step)


overlap_add_plain.calls = 0


def overlap_add(frames: torch.Tensor, step: int) -> torch.Tensor:
    """Overlap-add ``(..., T, WL)`` frames at hop ``step`` into
    ``(..., T*step + WL - step)``, each output sample written once.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (leading axes flattened into its batch) or raises.
    """
    if not frames.is_cuda:
        return overlap_add_plain(frames, step)
    return _overlap_add_cuda(frames, step)


def _overlap_add_cuda(frames: torch.Tensor, step: int) -> torch.Tensor:
    """Check the CUDA input, launch the kernel, count the launch."""
    _build.require_f32(frames, "overlap_add")
    *lead, t, wl = frames.shape
    if not 1 <= step <= wl:
        raise ValueError(f"overlap_add: need step in [1, {wl}], got {step}")
    fr = frames.reshape(-1, t, wl).contiguous()
    out_len = (t - 1) * step + wl
    out = torch.empty((fr.shape[0], out_len), dtype=torch.float32,
                      device=frames.device)
    err = _build.library().zt_overlap_add(
        fr.data_ptr(), out.data_ptr(), fr.shape[0], t, wl, step,
        _build.stream_of(frames))
    _build.check(err, "zt_overlap_add")
    overlap_add.launches += 1
    return out.reshape(*lead, out_len)


overlap_add.launches = 0
