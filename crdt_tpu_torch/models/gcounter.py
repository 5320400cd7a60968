"""G-Counter: grow-only counter lattice as a tensor (counterpart of
``crdt_tpu.models.gcounter``).

``counts: int32[..., n_nodes]`` — one slot per writer node, leading axes
batch replicas, so a (replicas, nodes) plane joins a million replicas in
one ``torch.maximum``.  join = elementwise max; value = the sum over the
node axis, wrapping mod 2^32 as XLA's int32 does.  A node index follows
JAX's ``.at[]`` rules (:func:`crdt_tpu_torch.models.oplog.at_slot`): a
negative index counts from the end once, one still out of range changes
nothing.
"""
from __future__ import annotations

import dataclasses

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models.oplog import at_slot


@dataclasses.dataclass
class GCounter:
    counts: torch.Tensor  # int32[..., n_nodes]

    @property
    def n_nodes(self) -> int:
        return self.counts.shape[-1]


def zero(n_nodes: int, batch: tuple = (), dtype=torch.int32, device=None) -> GCounter:
    """Identity element of join: the all-zero counter."""
    return GCounter(counts=torch.zeros((*batch, n_nodes), dtype=dtype,
                                       device=default_device(device)))


def add_at(x: torch.Tensor, index, amount) -> torch.Tensor:
    """``x.at[..., index].add(amount)``: a copy of ``x`` with ``amount`` (a
    Python int, or a tensor broadcast over the leading axes) added to entry
    ``index`` of the last axis, int32 sums wrapping.  A Python int goes to
    the card as a kernel argument, not as a copied tensor."""
    out = x.clone()
    slot = at_slot(index, x.shape[-1])
    if slot is not None:
        if not isinstance(amount, int):
            amount = torch.as_tensor(amount, dtype=x.dtype, device=x.device)
        out[..., slot] += amount
    return out


def increment(c: GCounter, node, amount=1) -> GCounter:
    """Local op: node ``node`` adds ``amount`` (must be >= 0) to its slot."""
    return GCounter(counts=add_at(c.counts, node, amount))


def join(a: GCounter, b: GCounter) -> GCounter:
    return GCounter(counts=torch.maximum(a.counts, b.counts))


def value(c: GCounter) -> torch.Tensor:
    return c.counts.sum(dim=-1, dtype=c.counts.dtype)
