"""Shared table-lattice migration helper (counterpart of
``crdt_tpu.utils.tables``).

Every sorted-table lattice keeps its padding rows at the tail, so capacity
growth is "place the old state at the head of a bigger empty"."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


def grow_into(state: Any, bigger_empty: Any) -> Any:
    """Copy ``state``'s tensor fields into the head of ``bigger_empty``'s (a
    freshly built empty of the larger capacity; same dataclass, each tensor
    at least as large in every dimension).  Non-tensor fields are taken
    from ``bigger_empty``."""
    out = {}
    for f in dataclasses.fields(state):
        old = getattr(state, f.name)
        new = getattr(bigger_empty, f.name)
        if isinstance(old, torch.Tensor):
            new = new.clone()
            new[tuple(slice(0, n) for n in old.shape)] = old.to(new.dtype)
        out[f.name] = new
    return type(bigger_empty)(**out)
