"""Derived composite models: the shipped instances of the CRDT algebra
(counterpart of ``crdt_tpu.models.composite``).

No join logic lives here — only the generic :class:`Pair` the pair-shaped
combinators use, the one action the semidirect instance needs, and the
registrations that derive models from registered parts through
:mod:`crdt_tpu_torch.ops.algebra`:

* ``mapof(pncounter)``               — the ormap of counters;
* ``lexicographic(lww,mvregister)``  — a register decided by
  last-writer-wins that carries the concurrent-sibling set of the winning
  write's era;
* ``semidirect(gcounter,pncounter)`` — an epoch-reset counter:
  :func:`reset_act` zeroes any pncounter contribution observed in a
  strictly older epoch;
* ``product(gcounter,pncounter)``    — the minimal product.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from crdt_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass
class Pair:
    """The generic two-part composite state (product / lexicographic /
    semidirect all share it)."""

    fst: Any
    snd: Any


def lww_rank(reg) -> torch.Tensor:
    """Total-order rank of an LWW register: the order-preserving packed
    (ts, rid) key (``lww.pack``)."""
    from crdt_tpu_torch.models import lww

    return lww.pack(reg).key


def reset_act(frame, observed, counter):
    """Semidirect action of the epoch gcounter on the pncounter: a
    contribution observed in a strictly older epoch frame resets to zero
    before joining; same-epoch contributions ride through."""
    from crdt_tpu_torch.models import gcounter

    stale = gcounter.value(observed) < gcounter.value(frame)
    return tree_map(lambda leaf: torch.where(stale, 0, leaf), counter)


def epoch_bump(state: Pair, node: int) -> Pair:
    """Local op on the epoch-reset counter: advance the epoch."""
    from crdt_tpu_torch.models import gcounter

    return Pair(fst=gcounter.increment(state.fst, node), snd=state.snd)


def epoch_add(state: Pair, node: int, amount: int) -> Pair:
    """Local op on the epoch-reset counter: count within the current epoch."""
    from crdt_tpu_torch.models import pncounter

    return Pair(fst=state.fst, snd=pncounter.add(state.snd, node, amount))


def epoch_value(state: Pair) -> torch.Tensor:
    from crdt_tpu_torch.models import pncounter

    return pncounter.value(state.snd)


_REGISTERED = False


def register_builtin_composites() -> None:
    """Derive and register the shipped composites (idempotent; called from
    ``crdt_tpu_torch.ops.joins._register_builtin_joins``)."""
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True

    from crdt_tpu_torch.ops import algebra

    algebra.mapof("pncounter")
    algebra.lexicographic("lww", "mvregister", rank=lww_rank)
    algebra.semidirect("gcounter", reset_act, "pncounter")
    algebra.product("gcounter", "pncounter")
