"""Process groups, device meshes and blocks for frame-block sharding.

The port of ``zaftpu.sharding.mesh`` on ``torch.distributed``. One process
runs per device (SPMD): NCCL joins the processes of CUDA cards, gloo those
of a CPU mesh. The canonical 1-D mesh axis, ``"frames"``, carries the
sequence dimension (a long recording cut into contiguous frame blocks); an
optional leading ``"batch"`` axis carries independent signals.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose device
type is the rank's device: ``"cuda"`` on an NCCL world, ``"cpu"`` on a
gloo one. Every rank of the world calls :func:`make_mesh` and
:func:`make_mesh_2d` (they create process groups, which every rank must),
also a rank the mesh leaves out: that rank gets a mesh on which the
sharded functions raise.

Where ``zaftpu`` returns one global array, the port returns each rank its
block; :func:`gather` puts the blocks back together.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

FRAME_AXIS = "frames"
BATCH_AXIS = "batch"


def initialize_distributed(backend: str | None = None, device=None,
                           **kwargs) -> None:
    """Join this process to the world (no-op if it has joined already).

    NCCL, with this process's card set to ``LOCAL_RANK`` (0 when unset),
    unless ``device`` is ``"cpu"``: then gloo. ``backend`` overrides the
    choice. ``kwargs`` go to :func:`torch.distributed.init_process_group`
    (``init_method``, ``rank``, ``world_size``, ``timeout``); without them
    the world comes from the environment ``torchrun`` sets. A failed start
    raises.
    """
    if dist.is_initialized():
        return
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if "nccl" in backend:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, **kwargs)


def _device_type() -> str:
    """The device type of this rank's mesh: ``"cuda"`` on an NCCL world,
    else ``"cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call initialize_distributed() (or "
            "torch.distributed.init_process_group) first")
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def _check_size(needed: int, what: str) -> None:
    world = dist.get_world_size()
    if needed > world:
        raise ValueError(f"mesh {what} needs {needed} devices, have {world}")


def make_mesh(n_devices: int | None = None,
              axis_name: str = FRAME_AXIS) -> DeviceMesh:
    """1-D mesh over ranks ``0 .. n_devices-1`` (default: the whole
    world). Every rank of the world calls it."""
    device_type = _device_type()
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    _check_size(n, str(n))
    return DeviceMesh(device_type, torch.arange(n),
                      mesh_dim_names=(axis_name,))


def make_mesh_2d(batch: int, frames: int) -> DeviceMesh:
    """``(batch, frames)`` mesh over ranks ``0 .. batch*frames-1``, row by
    row: data parallel x frame parallel. Every rank of the world calls
    it."""
    device_type = _device_type()
    _check_size(batch * frames, f"{batch}x{frames}")
    return DeviceMesh(device_type,
                      torch.arange(batch * frames).reshape(batch, frames),
                      mesh_dim_names=(BATCH_AXIS, FRAME_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_group(mesh: DeviceMesh, axis_name: str):
    """The process group of this rank along ``axis_name``; raises for a
    rank outside the mesh or an axis the mesh lacks."""
    if mesh.get_coordinate() is None:
        raise RuntimeError(
            f"rank {dist.get_rank()} is not in this mesh "
            f"({mesh.mesh.tolist()})")
    if axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"mesh has axes {mesh.mesh_dim_names}, not {axis_name!r}")
    return mesh.get_group(axis_name)


def block_bounds(length: int, n: int, index: int) -> tuple[int, int]:
    """``[lo, hi)`` of block ``index`` of ``n`` contiguous blocks of
    ``ceil(length / n)`` items (the last ones shorter or empty)."""
    size = -(-length // n)
    lo = min(index * size, length)
    return lo, min(lo + size, length)


def shard_along(x, mesh: DeviceMesh, axis_name: str = FRAME_AXIS,
                dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim``, split over
    ``axis_name`` in blocks of ``ceil(size / n)``, on this rank's device."""
    group = axis_group(mesh, axis_name)
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    lo, hi = block_bounds(x.shape[dim], dist.get_world_size(group),
                          dist.get_rank(group))
    return x.narrow(dim, lo, hi - lo).to(mesh_device(mesh))


def block_lengths(length: int, group, device) -> list[int]:
    """Every rank's ``length`` along ``group``, in group order."""
    n = dist.get_world_size(group)
    if n == 1:
        return [length]
    out = [torch.zeros(1, dtype=torch.int64, device=device)
           for _ in range(n)]
    dist.all_gather(out, torch.tensor([length], device=device), group=group)
    return [int(v) for v in out]


def _gather_along(block: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of every rank of ``group`` concatenated along ``dim`` in
    group order: an all-gather of their lengths, then of the blocks padded
    to the longest, trimmed back."""
    n = dist.get_world_size(group)
    if n == 1:
        return block
    dim = dim % block.ndim
    sizes = block_lengths(block.shape[dim], group, block.device)
    pad = list(block.shape)
    pad[dim] = max(sizes) - block.shape[dim]
    full = torch.cat([block, block.new_zeros(pad)], dim=dim)
    # gloo moves no complex tensors: gather their (re, im) view.
    wire = torch.view_as_real(full) if full.is_complex() else full
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire.contiguous(), group=group)
    if full.is_complex():
        parts = [torch.view_as_complex(p) for p in parts]
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                     dim=dim)


def gather(block: torch.Tensor, mesh: DeviceMesh, dim: int = -1,
           axis_name: str = FRAME_AXIS,
           batch_dim: int | None = None) -> torch.Tensor:
    """The whole of a sharded function's result from this rank's block:
    the blocks of the ranks along ``axis_name`` concatenated along ``dim``
    (-1, time or samples, by default; -2 for ``cqtspectrogram_tp``'s
    channels), then, when the result was also split by batch rows
    (``batch_dim``, 0 for a batched input on a 2-D mesh), those of the
    ranks along the batch axis. Every rank of the mesh calls it and gets
    the whole."""
    out = _gather_along(block, axis_group(mesh, axis_name), dim)
    if batch_dim is not None:
        out = _gather_along(out, axis_group(mesh, BATCH_AXIS), batch_dim)
    return out
