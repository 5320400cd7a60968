"""A small structure map over the port's state containers — what
``jax.tree.map`` does for the JAX package.

A state is a tensor, a dict / list / tuple of states, or a dataclass whose
tensor fields are leaves and whose dataclass or dict fields are states in
turn (``Gc.inner``); its other fields, such as ``ColumnarOpLog.bits``, are
static and are taken from the first state."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tree_map(fn: Callable, state: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``state`` and the same-shaped ``rest``."""
    if isinstance(state, torch.Tensor):
        return fn(state, *rest)
    if dataclasses.is_dataclass(state):
        out = {}
        for f in dataclasses.fields(state):
            x = getattr(state, f.name)
            if isinstance(x, torch.Tensor) or dataclasses.is_dataclass(x) \
                    or isinstance(x, dict):
                x = tree_map(fn, x, *(getattr(r, f.name) for r in rest))
            out[f.name] = x
        return type(state)(**out)
    if isinstance(state, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(tree_map(fn, *xs) for xs in zip(state, *rest))
    raise TypeError(f"tree_map: unsupported state type {type(state).__name__}")


def leaves(state: Any) -> list:
    """The tensor leaves of ``state``, in tree_map order."""
    out = []

    def visit(x):
        out.append(x)
        return x

    tree_map(visit, state)
    return out
