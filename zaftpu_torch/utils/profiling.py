"""Observability: trace ranges, device timers, throughput counters (the
port of ``zaftpu.utils.profiling``).

:func:`annotate` names a region in ``torch.profiler`` traces (and, on a
machine with a CUDA card, in NVTX timelines); :func:`timed` times a
function as ``zaftpu``'s does, warm-up, best of ``reps`` and back-to-back
``dispatches``, and reports frames/s, the framework's headline metric.
A call whose result lives on the card is timed with CUDA events around its
dispatches and a synchronize; one on the CPU with the host clock.
``zaftpu``'s ``fetch_sync`` and the subtraction of a second fetch work
around a remote TPU link's sync and are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

import torch

logger = logging.getLogger("zaftpu_torch")


@contextlib.contextmanager
def annotate(name: str):
    """Named trace region: a ``torch.profiler.record_function`` range and,
    with a CUDA card, an NVTX range."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@dataclasses.dataclass
class TransformStats:
    """One timed transform execution."""

    name: str
    seconds: float
    frames: int | None = None

    @property
    def frames_per_second(self) -> float | None:
        if self.frames is None or self.seconds == 0:
            return None
        return self.frames / self.seconds

    def __str__(self) -> str:
        fps = self.frames_per_second
        extra = f", {fps:,.0f} frames/s" if fps else ""
        return f"{self.name}: {self.seconds * 1e3:.2f} ms{extra}"


def _on_cuda(x) -> bool:
    """Whether ``x`` (a tensor, or a dict, tuple or list of them) holds a
    CUDA tensor."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_on_cuda(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return any(_on_cuda(v) for v in x)
    return False


def _timed_block(name: str, fn, args, dispatches: int, cuda: bool):
    """One timed block: ``dispatches`` back-to-back calls. On the card CUDA
    events around them and a synchronize; otherwise the host clock (with a
    synchronize if the block was the first to reach the card). Returns
    ``(result, seconds_per_call)``."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    with annotate(name):
        for _ in range(dispatches):
            result = fn(*args)
    if cuda:
        end.record()
        torch.cuda.synchronize()
        return result, start.elapsed_time(end) / 1e3 / dispatches
    if _on_cuda(result):
        torch.cuda.synchronize()
    return result, (time.perf_counter() - t0) / dispatches


def timed(name: str, fn, *args, frames: int | None = None, reps: int = 1,
          warmup: bool = True, log: bool = True, dispatches: int = 1,
          target_s: float | None = None):
    """Run ``fn(*args)``, best-of-``reps`` timing per call.

    ``dispatches`` > 1 issues that many back-to-back calls per rep and
    times them together. ``target_s`` sizes the dispatch count from a
    coarse first block so that each timed block holds about that much work
    (at most 1,024 calls). The calls run on the card when their inputs or
    result are CUDA tensors (CUDA events) and on the CPU otherwise (the
    host clock). Returns ``(result, TransformStats)``; logs at INFO when
    ``log``.
    """
    dispatches = max(1, dispatches)
    cuda = _on_cuda(args)
    if warmup:
        out = fn(*args)
        cuda = cuda or _on_cuda(out)
        if cuda:
            torch.cuda.synchronize()
        del out
    if target_s is not None:
        result, coarse = _timed_block(name, fn, args, dispatches, cuda)
        cuda = cuda or _on_cuda(result)
        dispatches = int(min(1024, max(dispatches,
                                       round(target_s / max(coarse, 1e-6)))))
    best = float("inf")
    result = None
    for _ in range(max(1, reps)):
        result, per_call = _timed_block(name, fn, args, dispatches, cuda)
        cuda = cuda or _on_cuda(result)
        best = min(best, per_call)
    stats = TransformStats(name=name, seconds=best, frames=frames)
    if log:
        logger.info("%s", stats)
    return result, stats
