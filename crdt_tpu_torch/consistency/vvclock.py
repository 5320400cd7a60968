"""VV-Clock: the version-vector watermark lattice as a tensor (counterpart
of ``crdt_tpu.consistency.vvclock``).

``seqs: int32[..., n_writers]`` — one slot per writer rid, ``-1`` = no op
from this writer seen yet (the ``vv.get(rid, -1)`` convention of the
nodes); leading axes batch tokens.  join = elementwise max with ``zero``
(all ``-1``) its identity, ``dominates`` the induced order, ``meet``
(elementwise min) the stable-frontier fold.  A writer index follows JAX's
``.at[]`` rules (:func:`crdt_tpu_torch.models.oplog.at_slot`).
"""
from __future__ import annotations

import dataclasses

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models.oplog import at_slot


@dataclasses.dataclass
class VVClock:
    seqs: torch.Tensor  # int32[..., n_writers]; -1 = writer unseen

    @property
    def n_writers(self) -> int:
        return self.seqs.shape[-1]


def zero(n_writers: int, batch: tuple = (), dtype=torch.int32, device=None) -> VVClock:
    """Identity element of join: no writer seen (all -1)."""
    return VVClock(seqs=torch.full((*batch, n_writers), -1, dtype=dtype,
                                   device=default_device(device)))


def advance(c: VVClock, writer, seq) -> VVClock:
    """Local op: witness writer's ops up through ``seq`` (the slot only
    moves up)."""
    seqs = c.seqs.clone()
    slot = at_slot(writer, c.n_writers)
    if slot is not None:
        seq = torch.as_tensor(seq, dtype=seqs.dtype, device=seqs.device)
        seqs[..., slot] = torch.maximum(seqs[..., slot], seq)
    return VVClock(seqs=seqs)


def join(a: VVClock, b: VVClock) -> VVClock:
    return VVClock(seqs=torch.maximum(a.seqs, b.seqs))


def meet(a: VVClock, b: VVClock) -> VVClock:
    """Greatest lower bound: every op at or under the meet is held by both
    clocks' owners."""
    return VVClock(seqs=torch.minimum(a.seqs, b.seqs))


def dominates(a: VVClock, b: VVClock) -> torch.Tensor:
    """bool[...]: a >= b in the lattice order; ``join(a, b) == a`` iff
    dominates(a, b)."""
    return (a.seqs >= b.seqs).all(dim=-1)


def ops_known(c: VVClock) -> torch.Tensor:
    """int32[...]: total ops under the watermark (sum of seq + 1)."""
    return (c.seqs + 1).sum(dim=-1, dtype=c.seqs.dtype)
