"""One rank of a gloo world for tests/test_torch_sharding.py.

    python tests/_torch_sharding_world.py WORLD RANK STORE OUT

``WORLD`` names the world and what it runs: ``1``, ``3`` and ``8`` (a 1-D
mesh over every rank: each sharded function and the halo exchange; at 3
ranks ``shard_along``; at 8 ranks also the tiny multi-hop shards, split4 on
a 4-rank mesh and a rank outside it, and a 2 x 4 batch x frames mesh) and
``2`` (``run_scaling``). The ranks meet on the file store ``STORE``; rank 0
writes every result, gathered whole, to ``OUT/results.npz``. It prints
``world up`` once its process group is up.

It imports torch, numpy and zaftpu_torch only, never JAX: the test holds
what it writes against ``zaftpu.sharding`` in its own process.
"""

from __future__ import annotations

import json
import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

SR, WL, STEP = 44100, 2048, 1024
TINY_WL, TINY_STEP = 512, 128
SEED = 20261018
WORLDS = {"1": 1, "3": 3, "8": 8, "2": 2}
HALO_BLOCK = 5     # samples of each rank's block in the halo cases
HALOS = (3, 12)    # a halo shorter than a block, and one over three blocks
SPLIT4_MESH = 4    # tests/test_bf16.py's split4 mesh
SPLIT4_ENV = {"ZAFTPU_PRECISION": "split4", "ZAFTPU_FFT": "matmul"}


def signal() -> np.ndarray:
    """One second at 44.1 kHz: two tones and noise from ``SEED``."""
    t = np.arange(SR) / SR
    noise = np.random.default_rng(SEED).standard_normal(SR)
    return (0.3 * np.sin(2 * np.pi * 440.0 * t)
            + 0.2 * np.sin(2 * np.pi * 2960.0 * t) + 0.05 * noise)


def split4_signal() -> np.ndarray:
    """tests/test_bf16.py's ``x32``: two seconds of seeded float32 noise."""
    return np.random.default_rng(0).standard_normal(SR * 2).astype(
        np.float32)


def tiny_signals(n_ranks: int = 8) -> tuple:
    """tests/test_sharding.py's large-overlap shapes at ``n_ranks`` shards:
    about 9 frames a shard, then 2 (the spill spans two shards)."""
    x = signal()
    return (x[:int(9.5 * n_ranks * TINY_STEP)],
            x[:n_ranks * 2 * TINY_STEP])


def halo_block(rank: int) -> np.ndarray:
    """Rank ``rank``'s ``(2, HALO_BLOCK)`` block in the halo cases."""
    return np.random.default_rng(SEED + rank).standard_normal(
        (2, HALO_BLOCK))


def halo_tail(rank: int, halo: int) -> np.ndarray:
    """Rank ``rank``'s ``(2, halo)`` overlap-add spill in the halo cases."""
    return np.random.default_rng(SEED + 100 + rank).standard_normal(
        (2, halo))


def _stacked(x: torch.Tensor, group=None) -> np.ndarray:
    """Every rank's ``x`` (one shape on all), stacked in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts).numpy()


def _halo_cases(mesh) -> dict:
    from zaftpu_torch.sharding import halo

    group = mesh.get_group()
    rank = dist.get_rank(group)
    block = torch.from_numpy(halo_block(rank))
    out = {}
    for h in HALOS:
        out[f"pull_{h}"] = _stacked(halo.pull_from_right(block, h, group),
                                    group)
        tail = torch.from_numpy(halo_tail(rank, h))
        out[f"push_{h}"] = _stacked(
            halo.push_right_sum(block.clone(), tail, group), group)
    return out


def _transforms(mesh) -> dict:
    """Each sharded function of the 1-D cases, gathered whole."""
    import zaftpu_torch as zt
    from zaftpu_torch import sharding as S
    from zaftpu_torch.core.windows import hamming, vorbis

    x = torch.from_numpy(signal())
    x32 = x.float()
    win, tdac = hamming(WL), vorbis(WL)
    fbank = zt.melfilterbank(SR, WL, 40)
    kern = zt.cqtkernel(SR, 24, 55, 3520)
    spec = zt.stft(x, win, STEP)
    coeffs = zt.mdct(x, tdac)

    def whole(y, dim=-1):
        return S.gather(y, mesh, dim).numpy()

    return {
        "stft": whole(S.stft_sharded(x, win, STEP, mesh)),
        "spectrogram": whole(S.spectrogram_sharded(x, win, STEP, mesh)),
        "istft": whole(S.istft_sharded(spec, win, STEP, mesh)),
        "roundtrip": whole(S.istft_sharded(
            S.stft_sharded(x, win, STEP, mesh), win, STEP, mesh,
            block=True)),
        "mel": whole(S.melspectrogram_sharded(x, win, STEP, fbank, mesh)),
        "mfcc": whole(S.mfcc_sharded(x, win, STEP, fbank, 20, mesh)),
        "mdct": whole(S.mdct_sharded(x, tdac, mesh)),
        "imdct": whole(S.imdct_sharded(coeffs, tdac, mesh)),
        "mdct_roundtrip": whole(S.imdct_sharded(
            S.mdct_sharded(x, tdac, mesh), tdac, mesh, block=True)),
        "cqt32": whole(S.cqtspectrogram_sharded(x32, SR, 25, kern, mesh)),
        "chroma32": whole(S.cqtchromagram_sharded(x32, SR, 25, 24, kern,
                                                  mesh)),
        "cqt64": whole(S.cqtspectrogram_sharded(x, SR, 25, kern, mesh)),
        "tp32": whole(S.cqtspectrogram_tp(x32, SR, 25, kern, mesh), -2),
        "tp64": whole(S.cqtspectrogram_tp(x, SR, 25, kern, mesh), -2),
        "stft32": whole(S.stft_sharded(x32, win.astype(np.float32), STEP,
                                       mesh)),
    }


def _tiny(mesh) -> dict:
    import zaftpu_torch as zt
    from zaftpu_torch import sharding as S
    from zaftpu_torch.core.windows import hamming

    win = hamming(TINY_WL)
    short, tiny = (torch.from_numpy(s) for s in tiny_signals())
    out = {"tiny_stft": S.stft_sharded(short, win, TINY_STEP, mesh)}
    for name, x in (("tiny_istft", short), ("tiny2_istft", tiny)):
        out[name] = S.istft_sharded(zt.stft(x, win, TINY_STEP), win,
                                    TINY_STEP, mesh)
    return {k: S.gather(v, mesh).numpy() for k, v in out.items()}


def _split4_and_outside() -> dict:
    """stft_sharded under split4 on ranks 0-3's mesh; ranks 4-7, outside
    it, must get an error from the same call."""
    from zaftpu_torch import sharding as S
    from zaftpu_torch.core.windows import hamming

    mesh = S.make_mesh(SPLIT4_MESH)
    x = torch.from_numpy(split4_signal())
    win = hamming(WL).astype(np.float32)
    os.environ.update(SPLIT4_ENV)
    out, raised = {}, False
    try:
        if dist.get_rank() < SPLIT4_MESH:
            out["split4_stft"] = S.gather(S.stft_sharded(x, win, STEP, mesh),
                                          mesh).numpy()
        else:
            try:
                S.stft_sharded(x, win, STEP, mesh)
            except RuntimeError:
                raised = True
    finally:
        for key in SPLIT4_ENV:
            os.environ.pop(key)
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, raised)
    out["outside_raised"] = np.array(flags)
    return out


def _shard_along(mesh) -> dict:
    from zaftpu_torch import sharding as S

    x = torch.from_numpy(signal()[:8192])
    part = S.shard_along(x, mesh, dim=0)
    lengths = [None] * dist.get_world_size()
    dist.all_gather_object(lengths, part.shape[0])
    return {"shard_along": S.gather(part, mesh, dim=0).numpy(),
            "shard_along_lengths": np.array(lengths)}


def run_1d(world: int) -> dict:
    from zaftpu_torch.sharding import make_mesh

    mesh = make_mesh(world)
    out = {**_transforms(mesh), **_halo_cases(mesh)}
    if world == 3:
        out.update(_shard_along(mesh))
    if world == 8:
        out.update(_tiny(mesh))
        out.update(_split4_and_outside())
        out.update(_batch_by_frames())
    return out


def _batch_by_frames() -> dict:
    """tests/test_sharding.py's batch x frames cases and the TP CQT on a
    2 x 4 mesh, each gathered over both axes."""
    import zaftpu_torch as zt
    from zaftpu_torch import sharding as S
    from zaftpu_torch.core.windows import hamming, vorbis

    mesh = S.make_mesh_2d(2, 4)
    x = signal()
    batch = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    win, tdac = hamming(WL), vorbis(WL)
    fbank = zt.melfilterbank(SR, WL, 40)
    kern = zt.cqtkernel(SR, 24, 55, 3520)
    spec = S.stft_sharded(batch, win, STEP, mesh)
    out = {
        "batch_stft": spec,
        "batch_roundtrip": S.istft_sharded(spec, win, STEP, mesh,
                                           block=True),
        "batch_mfcc": S.mfcc_sharded(batch, win, STEP, fbank, 20, mesh),
        "batch_mdct_roundtrip": S.imdct_sharded(
            S.mdct_sharded(batch, tdac, mesh), tdac, mesh, block=True),
    }
    out = {k: S.gather(v, mesh, batch_dim=0).numpy() for k, v in out.items()}
    out["tp_2x4"] = S.gather(
        S.cqtspectrogram_tp(batch.float(), SR, 25, kern, mesh), mesh, dim=-2,
        batch_dim=0).numpy()
    return out


def run_scaling() -> dict:
    from zaftpu_torch.bench.harness import run_scaling as scaling

    rows = scaling(seconds=0.5, reps=1, device="cpu")
    return {"scaling": np.array(json.dumps(rows))}


def main(argv: list) -> None:
    world_name, rank, store, out_dir = argv
    rank, world = int(rank), WORLDS[world_name]
    torch.set_num_threads(1)
    from zaftpu_torch.sharding import initialize_distributed

    initialize_distributed(device="cpu", init_method=f"file://{store}",
                           rank=rank, world_size=world,
                           timeout=timedelta(seconds=60))
    print("world up", flush=True)
    try:
        if world_name == "2":
            results = run_scaling()
        else:
            results = run_1d(world)
        if rank == 0:
            np.savez(os.path.join(out_dir, "results.npz"), **results)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
