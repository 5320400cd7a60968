"""Sorted-segment union: the core set-join primitive, plain torch
(counterpart of ``crdt_tpu.ops.sorted_union``).

Both operands are sorted, sentinel-padded, fixed-capacity tensors; the
union is sort + adjacent-duplicate merge + compaction.  Every function
here works along the LAST dimension, so any leading dimensions are batch
dimensions (the JAX package vmaps the single-instance function instead).

Conventions
-----------
* Keys are a tuple of int32 columns, compared lexicographically.
* Padding rows have ALL key columns equal to ``SENTINEL`` and sort to the
  tail.  Real keys are strictly below the sentinel.
* Each input has unique keys; the union therefore sees each key at most
  twice, so duplicate merging only ever looks one row ahead.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch

from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tree import tree_map


def keep_first(v_first, v_second):
    """Default duplicate combiner: keep the first (stable sort ⇒ the 'a' /
    local side) value — the reference's local-wins collision rule, which
    for true CRDT ops is a no-op since identical keys carry identical
    payloads."""
    del v_second
    return v_first


def sorted_union(
    keys_a: Sequence[torch.Tensor],
    vals_a: Any,
    keys_b: Sequence[torch.Tensor],
    vals_b: Any,
    combine: Callable[[Any, Any], Any] = keep_first,
    out_size: int | None = None,
) -> Tuple[Tuple[torch.Tensor, ...], Any, torch.Tensor]:
    """Union two sorted keyed tensors along their last dimension.

    Args:
      keys_a/keys_b: tuples of int32[..., n_a]/int32[..., n_b] columns,
        lexicographically sorted ascending, padded with SENTINEL in every
        column.
      vals_a/vals_b: matching structures (dict / tuple / tensor) of
        [..., n_a]/[..., n_b] tensors.
      combine: duplicate merger ``(vals_row_a, vals_row_b) -> vals_row``
        applied where a key occurs in both inputs (whole structures,
        vectorized).
      out_size: output capacity; defaults to n_a + n_b (lossless).  If the
        true union exceeds it, the largest keys are dropped.

    Returns:
      (keys, vals, n_unique): the unioned columns/values (sorted, sentinel-
      padded, cut to out_size) and the number of unique real keys
      (int32[...]).
    """
    n_keys = len(keys_a)
    if n_keys != len(keys_b):
        raise ValueError(f"key arity differs: {n_keys} vs {len(keys_b)}")
    keys = [torch.cat([ka, kb], dim=-1) for ka, kb in zip(keys_a, keys_b)]
    vals = tree_map(lambda xa, xb: torch.cat([xa, xb], dim=-1), vals_a, vals_b)

    keys, vals = _sort_by_keys(keys, vals, n_keys)

    # A row duplicates its predecessor iff every key column matches.
    dup = torch.ones_like(keys[0], dtype=torch.bool)
    for k in keys:
        dup &= k == torch.cat([k[..., :1] - 1, k[..., :-1]], dim=-1)
    valid = keys[0] != SENTINEL_PY

    # Merge each duplicate pair into its first row.  Stable sort + a-before-b
    # concat order ⇒ the first row of a pair is always the 'a' side.
    next_is_dup = torch.cat([dup[..., 1:], torch.zeros_like(dup[..., :1])], dim=-1)
    vals_next = tree_map(lambda x: torch.roll(x, -1, dims=-1), vals)
    vals_merged = combine(vals, vals_next)
    vals = tree_map(
        lambda v, m: torch.where(next_is_dup, m, v), vals, vals_merged
    )

    # Drop second occurrences: sentinel their keys, then re-sort to compact.
    keys = [k.masked_fill(dup, SENTINEL_PY) for k in keys]
    keys, vals = _sort_by_keys(keys, vals, n_keys)

    # Canonicalize padding: dropped rows sort into the tail still carrying
    # their stale values; zero them so states compare equal structurally.
    pad = keys[0] == SENTINEL_PY
    vals = tree_map(lambda v: v.masked_fill(pad, 0), vals)

    n_unique = (valid & ~dup).sum(dim=-1, dtype=torch.int32)

    if out_size is not None:
        keys = [k[..., :out_size] for k in keys]
        vals = tree_map(lambda x: x[..., :out_size], vals)
    return tuple(keys), vals, n_unique


def _sort_by_keys(keys, vals, n_keys):
    """Stable lexicographic sort of ``keys`` (most significant first) along
    the last dimension, carrying ``vals`` — ``lax.sort(num_keys=n_keys,
    is_stable=True)``.  torch has no multi-key sort, so this runs one
    stable pass per key word from the least significant up, each pass
    sorting the word gathered through the permutation built so far."""
    perm = None
    for k in reversed(keys[:n_keys]):
        word = k if perm is None else k.gather(-1, perm)
        idx = torch.sort(word, dim=-1, stable=True).indices
        perm = idx if perm is None else perm.gather(-1, idx)
    keys = [k.gather(-1, perm) for k in keys]
    vals = tree_map(lambda v: v.gather(-1, perm), vals)
    return keys, vals


def get_engine(name: str):
    """The shared engine seam: a columnar set-union engine by name
    ("sort" | "bucket" | "bitmap"); see :mod:`crdt_tpu_torch.ops.union_engine`
    for the layouts and the auto-dispatch rule.  Imported when called, so
    this module stays free of the engines' imports."""
    from crdt_tpu_torch.ops import union_engine

    return union_engine.get_engine(name)
