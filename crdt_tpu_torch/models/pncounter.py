"""PN-Counter: increment/decrement counter lattice as tensors (counterpart
of ``crdt_tpu.models.pncounter``).

Two G-Counter planes, ``pos`` and ``neg``: int32[..., n_nodes].
Increments go to ``pos[node]``, decrements add ``|amount|`` to
``neg[node]``.  join = elementwise max of both planes; value = sum(pos) -
sum(neg), wrapping.  As in JAX, ``-amount`` wraps too: an amount of -2^31
adds nothing to either plane.
"""
from __future__ import annotations

import dataclasses

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models.gcounter import add_at


@dataclasses.dataclass
class PNCounter:
    pos: torch.Tensor  # int32[..., n_nodes]
    neg: torch.Tensor  # int32[..., n_nodes]

    @property
    def n_nodes(self) -> int:
        return self.pos.shape[-1]


def zero(n_nodes: int, batch: tuple = (), dtype=torch.int32, device=None) -> PNCounter:
    z = torch.zeros((*batch, n_nodes), dtype=dtype, device=default_device(device))
    return PNCounter(pos=z, neg=z.clone())


def _wrap32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def add(c: PNCounter, node, amount) -> PNCounter:
    """Local op: node applies a signed integer delta (a Python int, or a
    tensor broadcast over the leading axes)."""
    if isinstance(amount, int):
        if not -2**31 <= amount < 2**31:
            raise OverflowError(f"amount {amount} does not fit int32")
        pos, neg = max(amount, 0), max(_wrap32(-amount), 0)
    else:
        amount = torch.as_tensor(amount, dtype=c.pos.dtype, device=c.pos.device)
        pos, neg = amount.clamp(min=0), torch.neg(amount).clamp(min=0)
    return PNCounter(pos=add_at(c.pos, node, pos), neg=add_at(c.neg, node, neg))


def join(a: PNCounter, b: PNCounter) -> PNCounter:
    return PNCounter(pos=torch.maximum(a.pos, b.pos), neg=torch.maximum(a.neg, b.neg))


def value(c: PNCounter) -> torch.Tensor:
    return c.pos.sum(dim=-1, dtype=c.pos.dtype) - c.neg.sum(dim=-1, dtype=c.neg.dtype)
