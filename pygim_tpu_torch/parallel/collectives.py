"""The ``sp`` merge of the 2D mesh, the port's counterpart of the
reference's ``jax.lax.psum`` / ``psum_scatter`` over the ``sp`` axis
(``pygim_tpu/parallel/spmm_2d.py:385-393``).

Both sum the ``sp`` shards' partial products in shard order, 0 first,
so the same partials give the same bits whatever the devices. A partial
on another device than the sum's comes over with ``.to(dst)``: on a
virtual mesh (one device repeated) that moves nothing, across cards it
is a peer copy; one code path serves both.
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
