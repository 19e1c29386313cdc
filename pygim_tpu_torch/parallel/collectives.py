"""The collectives of the port's meshes, counterparts of the reference's
``jax.lax`` collectives inside its ``shard_map`` programs:

* :func:`psum` / :func:`psum_scatter`: the 2D mesh's ``sp`` merge
  (``pygim_tpu/parallel/spmm_2d.py:385-393``). Both sum the ``sp``
  shards' partial products in shard order, 0 first, so the same partials
  give the same bits whatever the devices.
* :func:`all_gather`, :func:`all_to_all` and :func:`ppermute`: the halo
  layout's three exchanges (``pygim_tpu/parallel/halo.py:598-830``), in
  the reference's buffer layouts, so the halo tables index the same rows.

A tensor on another device than its destination comes over with
``.to(dst)``: on a virtual mesh (one device repeated) that moves nothing,
across cards it is a peer copy; one code path serves both.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def psum(parts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in that order, on ``device`` (default
    ``parts[0]``'s). The sum is taken in ``parts[0]``'s storage where it
    lies on ``device`` (the partials are the caller's own buffers)."""
    dst = parts[0].device if device is None else torch.device(device)
    acc = parts[0].to(dst)
    for p in parts[1:]:
        acc.add_(p.to(dst))
    return acc


def psum_scatter(parts: Sequence[torch.Tensor],
                 devices: Optional[Sequence] = None) -> list:
    """Row block ``s`` of :func:`psum` for each shard ``s``, on
    ``devices[s]`` (default each partial's own): the partials' rows are
    ``sp`` equal blocks (the caller pads the rows to a multiple of
    ``sp``)."""
    sp = len(parts)
    n = parts[0].shape[0]
    if n % sp:
        raise ValueError(f"{n} rows do not split into {sp} equal blocks")
    b = n // sp
    devices = devices or [p.device for p in parts]
    return [psum([p[s * b:(s + 1) * b] for p in parts], devices[s])
            for s in range(sp)]


def all_gather(parts: Sequence[torch.Tensor], devices: Sequence) -> list:
    """``jax.lax.all_gather(x, tiled=True)``: for each shard ``d``, the
    concatenation of every shard's ``parts[p]`` in shard order, on
    ``devices[d]``. Shards on one device share one buffer."""
    made = {}
    out = []
    for dst in devices:
        dst = torch.device(dst)
        if dst not in made:
            made[dst] = torch.cat([p.to(dst) for p in parts])
        out.append(made[dst])
    return out


def all_to_all(send: Sequence[torch.Tensor], devices: Sequence) -> list:
    """``jax.lax.all_to_all(split_axis=0, concat_axis=0)`` of ``(nd, K,
    H)`` send buffers: shard ``d`` receives, in slot ``p``, peer ``p``'s
    ``send[p][d]``; returned as ``(nd · K, H)`` on ``devices[d]``."""
    nd = len(send)
    return [torch.cat([send[p][d].to(devices[d]) for p in range(nd)])
            for d in range(nd)]


def ppermute(parts: Sequence[torch.Tensor], shift: int,
             devices: Sequence) -> list:
    """``jax.lax.ppermute`` with ``perm = [(j, (j + shift) % nd)]``: shard
    ``(j + shift) % nd`` receives ``parts[j]``, on its device."""
    nd = len(parts)
    out = [None] * nd
    for j in range(nd):
        dst = (j + shift) % nd
        out[dst] = parts[j].to(devices[dst])
    return out
