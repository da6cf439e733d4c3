"""Benchmark harness: per-transform throughput (the port of
``zaftpu.bench.harness``).

    python -m zaftpu_torch.bench.harness [--seconds S] [--reps R]
        [--dispatches D] [--device cuda|cpu] [--scaling]

times every transform through the public entry points and prints one JSON
row per transform: the best and the median seconds of one pass over the
signal, its frames and frames/s, and the kernel launches of one pass (the
wrappers' ``launches`` counters; none on the CPU, where the plain versions
run). The rows and their frame counts are ``zaftpu``'s, plus
``griffin_lim`` and the DCT / DST of types 1, 3 and 4. Reps go round-robin
over the rows (rep 1 of every row, then rep 2, ...), so a slow spell of the
machine lands on every row alike. On the card the suite times with CUDA
events (:func:`zaftpu_torch.utils.profiling.timed`); without a card
``device="cuda"`` raises rather than timing the CPU.

``--scaling`` (:func:`run_scaling`) times the frame-sharded
``stft_sharded -> istft_sharded`` round trip on meshes of 1, 2 and all
ranks instead, as ``zaftpu``'s does: in one plain process on a world of one
it brings up itself, under ``torchrun --nproc-per-node N`` on the world it
is given (NCCL on the cards, gloo with ``--device cpu``); rank 0 prints the
rows.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import pkgutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

SR, WL, STEP = 44100, 2048, 1024
BATCH = 1024  # rows (and length) of the DCT / DST batch


def _signal(seconds: float, sr: int = SR) -> np.ndarray:
    """``seconds`` of float32 mono: the recording ``ZAFTPU_FIXTURE`` names,
    tiled, when the file exists (``zaftpu``'s suite reads the reference's
    audio file), else a 0.4-amplitude 440-Hz tone, as ``zaftpu``'s
    fallback."""
    n = int(seconds * sr)
    path = os.environ.get("ZAFTPU_FIXTURE")
    if path and os.path.exists(path):
        from zaftpu_torch.io.wav import wavread

        x, _ = wavread(path)
        mono = (x.mean(axis=1) if x.ndim == 2 else x).astype(np.float32)
        return np.tile(mono, -(-n // len(mono)))[:n]
    t = np.arange(n, dtype=np.float32) / sr
    return (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


def _segment_seconds() -> float:
    """Segment size for long signals (``ZAFTPU_BENCH_SEGMENT_SECONDS``,
    default 600, as ``zaftpu``'s): an hour runs as back-to-back 600-s
    calls, as the streaming pipeline runs it in blocks."""
    try:
        return float(os.environ.get("ZAFTPU_BENCH_SEGMENT_SECONDS", "600"))
    except ValueError:
        return 600.0


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: the bench suite times the card; pass --device cpu "
            "(device='cpu') to run it on the CPU")
    return dev


def kernel_wrappers() -> dict:
    """Every kernel wrapper of :mod:`zaftpu_torch.kernels` that counts its
    launches, by ``module.function``."""
    from zaftpu_torch import kernels

    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        if info.name.startswith("_"):
            continue
        module = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for attr, obj in vars(module).items():
            if (callable(obj) and hasattr(obj, "launches")
                    and obj.__module__ == module.__name__):
                out[f"{info.name}.{attr}"] = obj
    return out


def _segments(seconds: float, dev: torch.device) -> list:
    """The signal as 600-s segments on ``dev``, one tensor uploaded for
    each distinct segment length (the tone, or the tiled recording,
    repeats, so equal lengths hold equal samples)."""
    host = _signal(seconds)
    seg_len = int(_segment_seconds() * SR)
    if seconds <= _segment_seconds():
        seg_len = len(host)
    uploaded: dict = {}
    segments = []
    for lo in range(0, len(host), seg_len):
        piece = host[lo:lo + seg_len]
        if len(piece) not in uploaded:
            uploaded[len(piece)] = torch.from_numpy(piece).to(dev)
        segments.append(uploaded[len(piece)])
    return segments


def _per_input(fn, inputs: list) -> list:
    """``fn`` of each input, computed once for each distinct tensor."""
    memo: dict = {}
    out = []
    for x in inputs:
        if id(x) not in memo:
            memo[id(x)] = fn(x)
        out.append(memo[id(x)])
    return out


def _one_pass(fn, inputs: list):
    """``fn`` over every input; each output is released as the next call
    is issued (so the allocator can reuse its memory), and the last is
    returned."""
    out = None
    for x in inputs:
        del out
        out = fn(x)
    return out


def run_transform_suite(seconds: float = 60.0, reps: int = 3,
                        dispatches: int = 1, device="cuda") -> list:
    """Time every transform on ``device``; returns one dict per row."""
    import zaftpu_torch as zt
    from zaftpu_torch.core.windows import hamming, vorbis
    from zaftpu_torch.utils.profiling import annotate, timed

    dev = _device(device)
    signals = _segments(seconds, dev)
    window = hamming(WL).astype(np.float32)
    tdac = vorbis(WL).astype(np.float32)
    fbank = zt.melfilterbank(SR, WL, 40)
    kernel = zt.cqtkernel(SR, 24, 55, 3520)
    lens = [int(x.shape[0]) for x in signals]
    t_stft = sum(int(np.ceil((n + 2 * (WL // 2) - WL) / STEP)) + 1
                 for n in lens)
    t_mdct = sum(int(np.ceil(n / STEP)) + 1 for n in lens)
    t_cqt = sum(n // round(SR / 25) for n in lens)

    specs = _per_input(lambda x: zt.stft(x, window, STEP), signals)
    mags = _per_input(lambda s: s[:WL // 2 + 1].abs(), specs)
    coeffs = _per_input(lambda x: zt.mdct(x, tdac), signals)
    batch = [signals[0][:BATCH].repeat(BATCH, 1)]
    rows = [
        ("stft", lambda x: zt.stft(x, window, STEP), t_stft, signals),
        ("istft", lambda s: zt.istft(s, window, STEP), t_stft, specs),
        ("spectrogram", lambda x: zt.spectrogram(x, window, STEP), t_stft,
         signals),
        ("melspectrogram", lambda x: zt.melspectrogram(x, window, STEP,
                                                       fbank),
         t_stft, signals),
        ("mfcc", lambda x: zt.mfcc(x, window, STEP, fbank, 20), t_stft,
         signals),
        ("mdct", lambda x: zt.mdct(x, tdac), t_mdct, signals),
        ("imdct", lambda c: zt.imdct(c, tdac), t_mdct, coeffs),
        ("cqtspectrogram", lambda x: zt.cqtspectrogram(x, SR, 25, kernel),
         t_cqt, signals),
        ("cqtchromagram",
         lambda x: zt.cqtchromagram(x, SR, 25, 24, kernel), t_cqt, signals),
        ("dct2_batch1024", lambda b: zt.dct(b, 2), BATCH, batch),
        ("dst2_batch1024", lambda b: zt.dst(b, 2), BATCH, batch),
        ("griffin_lim", lambda m: zt.griffin_lim(m, window, STEP), t_stft,
         mags),
        *((f"{kind}{ttype}_batch1024",
           lambda b, f=getattr(zt, kind), t=ttype: f(b, t), BATCH, batch)
          for kind in ("dct", "dst") for ttype in (1, 3, 4)),
    ]
    wrappers = kernel_wrappers()

    def counts() -> dict:
        return {k: w.launches for k, w in wrappers.items()}

    # A warm-up pass of each row, counting its launches.
    launches = {}
    for name, fn, _, inputs in rows:
        before = counts()
        with annotate(name):
            out = _one_pass(fn, inputs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        del out
        launches[name] = {k: n - before[k] for k, n in counts().items()
                          if n > before[k]}
    seconds_of = {name: [] for name, *_ in rows}
    for _ in range(max(1, reps)):
        for name, fn, frames, inputs in rows:
            out, stats = timed(name, _one_pass, fn, inputs, frames=frames,
                               warmup=False, log=False, dispatches=dispatches)
            del out  # before the next row's pass
            seconds_of[name].append(stats.seconds)
    return [{"transform": name, "seconds": min(seconds_of[name]),
             "median_seconds": statistics.median(seconds_of[name]),
             "frames": frames,
             "frames_per_sec": frames / min(seconds_of[name]),
             "launches": launches[name]}
            for name, _, frames, _ in rows]


def _spmd_seconds(fn, group, dev: torch.device) -> float:
    """Seconds of one call of ``fn`` on every rank of ``group``: from a
    barrier to the slowest rank's finish (its device synchronised), on the
    host clock."""
    import torch.distributed as dist

    size = dist.get_world_size(group)
    if size > 1:
        dist.barrier(group=group)
    start = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = torch.tensor([time.perf_counter() - start], dtype=torch.float64,
                           device=dev)
    del out
    if size > 1:
        dist.all_reduce(elapsed, op=dist.ReduceOp.MAX, group=group)
    return float(elapsed)


def run_scaling(seconds: float = 60.0, reps: int = 3, device="cuda") -> list:
    """Frame-sharded ``stft_sharded -> istft_sharded`` (the spectrum stays
    in blocks: nothing is gathered between) frames/s on meshes of 1, 2 and
    all ranks of the world, best of ``reps`` after a warm-up; each call
    timed from a barrier to the slowest rank's finish. Every rank calls
    it; rank 0's rows cover every mesh, with ``scaling_efficiency`` =
    frames/s over (the one-rank frames/s times the mesh's ranks). Without
    a process group it brings one up (the ``torchrun`` environment's, or
    else a world of one on a file store) and takes it down after."""
    import torch.distributed as dist

    from zaftpu_torch.core.frame import stft_padding
    from zaftpu_torch.core.windows import hamming
    from zaftpu_torch.sharding import (initialize_distributed, istft_sharded,
                                       make_mesh, stft_sharded)

    dev = _device(device)
    with contextlib.ExitStack() as stack:
        if not dist.is_initialized():
            if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
                initialize_distributed(device=dev.type)
            else:
                store = stack.enter_context(tempfile.TemporaryDirectory())
                initialize_distributed(
                    device=dev.type, init_method=f"file://{store}/store",
                    rank=0, world_size=1)
            stack.callback(dist.destroy_process_group)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        world, rank = dist.get_world_size(), dist.get_rank()
        signal = torch.from_numpy(_signal(seconds)).to(dev)
        window = hamming(WL).astype(np.float32)
        frames = stft_padding(signal.shape[-1], WL, STEP)[2]
        rows = []
        for size in sorted({1, 2, world} & set(range(1, world + 1))):
            mesh = make_mesh(size)
            if rank < size:
                def pipeline(mesh=mesh):
                    spec = stft_sharded(signal, window, STEP, mesh)
                    return istft_sharded(spec, window, STEP, mesh,
                                         block=True)

                group = mesh.get_group()
                _spmd_seconds(pipeline, group, dev)  # warm-up
                best = min(_spmd_seconds(pipeline, group, dev)
                           for _ in range(max(1, reps)))
                rows.append({"devices": size, "seconds": best,
                             "frames": frames,
                             "frames_per_sec": frames / best})
            if world > 1:
                dist.barrier()
    base = rows[0]["frames_per_sec"]
    for row in rows:
        row["scaling_efficiency"] = row["frames_per_sec"] / (
            base * row["devices"])
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Time every zaftpu_torch transform; one JSON row each.")
    parser.add_argument("--seconds", type=float, default=60.0)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--dispatches", type=int, default=1,
                        help="back-to-back passes per timed rep")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--scaling", action="store_true",
                        help="the sharded stft -> istft on 1, 2 and all "
                             "ranks instead of the suite")
    args = parser.parse_args(argv)

    dev = _device(args.device)
    if dev.type == "cuda":
        print(f"# device: cuda, {torch.cuda.get_device_name(dev)}, devices: "
              f"{torch.cuda.device_count()}", file=sys.stderr)
    else:
        print(f"# device: cpu, threads: {torch.get_num_threads()}",
              file=sys.stderr)
    if args.scaling:
        rows = run_scaling(args.seconds, args.reps, dev)
        if int(os.environ.get("RANK", "0")):
            return
    else:
        rows = run_transform_suite(args.seconds, args.reps, args.dispatches,
                                   dev)
    for row in rows:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
