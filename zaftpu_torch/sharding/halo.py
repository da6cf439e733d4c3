"""Halo exchange for frame-block sharding, on ``torch.distributed``.

The port of ``zaftpu.sharding.halo``. Every transform is frame-local with
a bounded overlap (``window_length - step`` for the STFT and MDCT, in both
directions; ``fft_length - step`` for the CQT), so sharding a long signal
by contiguous frame blocks needs two exchanges with the neighbours:

* analysis: each rank appends the first ``halo`` samples of its right
  neighbour's block, so that its last frames are whole
  (:func:`pull_from_right`);
* synthesis: each rank's overlap-add spills ``halo`` samples into its right
  neighbour's region, which are sent right and summed there
  (:func:`push_right_sum`).

Each hop is one :func:`torch.distributed.batch_isend_irecv` inside the
group of the mesh's frame axis, to and from peers named by their global
rank (:func:`torch.distributed.get_global_rank`). Ranks past an edge
contribute zeros, which is exact because the callers lay the signal out so
that everything beyond the sharded body is zero. A halo longer than one
block (tiny blocks; the CQT's 31k-sample reach) takes as many hops as it
spans. A group of one rank exchanges nothing, and a rank with nothing to
send or receive in a hop sits that hop out.

Both functions work on the last axis; leading axes are batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _zeros_tail(block: torch.Tensor, length: int) -> torch.Tensor:
    return block.new_zeros(block.shape[:-1] + (length,))


def _hop(group, send: torch.Tensor | None, to: int | None,
         recv: torch.Tensor | None, source: int | None) -> None:
    """One hop: send ``send`` to group rank ``to`` and receive ``recv``
    from group rank ``source``, either of them absent."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(group, to), group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, source), group))
    if ops:
        for request in dist.batch_isend_irecv(ops):
            request.wait()


def pull_from_right(block: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Append the first ``halo`` samples of the right neighbour(s)' blocks.

    ``block``: this rank's ``(..., local_len)`` samples; every rank of
    ``group`` holds as many. Returns ``(..., local_len + halo)``; samples
    from past the last rank are zeros.
    """
    if halo == 0:
        return block
    n = dist.get_world_size(group)
    if n == 1:
        return torch.cat([block, _zeros_tail(block, halo)], dim=-1)
    index = dist.get_rank(group)
    block_len = block.shape[-1]
    out = [block]
    remaining = halo
    for h in range(1, -(-halo // block_len) + 1):
        take = min(block_len, remaining)
        recv = (block.new_empty(block.shape[:-1] + (take,))
                if index + h < n else None)
        _hop(group, block[..., :take] if index - h >= 0 else None,
             index - h, recv, index + h)
        out.append(recv if recv is not None else _zeros_tail(block, take))
        remaining -= take
    if remaining > 0:
        out.append(_zeros_tail(block, remaining))
    return torch.cat(out, dim=-1)


def push_right_sum(body: torch.Tensor, tail: torch.Tensor,
                   group) -> torch.Tensor:
    """Send ``tail`` to the right neighbour(s) and add what arrives from
    the left onto the start of ``body`` (last axis), in place.

    This is the overlap-add boundary exchange: rank i's local overlap-add
    spills ``tail.shape[-1]`` samples past its body; chunk c of the tail
    lands at the start of rank i+1+c. What spills past the last rank is
    dropped (callers lay the signal out so that it is trimmed anyway);
    rank 0 receives nothing.
    """
    halo = tail.shape[-1]
    n = dist.get_world_size(group)
    if halo == 0 or n == 1:
        return body
    index = dist.get_rank(group)
    body_len = body.shape[-1]
    for c in range(-(-halo // body_len)):
        if n - 1 - c <= 0:
            break
        piece = tail[..., c * body_len:(c + 1) * body_len]
        to, source = index + 1 + c, index - 1 - c
        recv = piece.new_empty(piece.shape) if source >= 0 else None
        _hop(group, piece if to < n else None, to, recv, source)
        if recv is not None:
            body[..., :piece.shape[-1]] += recv
    return body
