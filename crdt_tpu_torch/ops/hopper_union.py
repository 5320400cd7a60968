"""Fused columnar lexN sorted-set union: the hand-written Hopper kernel
(``csrc/lexn_union.cu``) and its plain PyTorch twin.

Counterpart of ``crdt_tpu.ops.pallas_union.sorted_union_columnar_fused_lexn``
and ``sorted_union_columnar_fused_lex2`` (the OpLog swarm's merge).  The
host contract is the JAX one: planes are ``(C, L)`` int32 with lane j
holding one replica's rows, per-lane sorted ascending over the n_keys
lexicographic key words, padding rows SENTINEL in every key word and 0 in
every value plane; C is a power of two.  The result is the union truncated
to ``out_size`` rows, duplicates OR-combined into the kept copy
(OR-combine-then-keep-first), with the pre-truncation ``n_unique`` per
lane.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor runs
the plain twin ``_lexn_union_plain``.  There is no fallback from one to the
other.  ``LAUNCHES["lexn_union"]`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from crdt_tpu_torch import _build
from crdt_tpu_torch.ops.sorted_union import _sort_by_keys
from crdt_tpu_torch.utils.constants import SENTINEL_PY

LAUNCHES = {"lexn_union": 0}

# instantiated (n_keys, n_vals) splits of the kernel template
KERNEL_SPLITS = ((2, 2),)


def _check_planes(planes: Sequence[torch.Tensor], shape, device) -> None:
    for p in planes:
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"plane is {type(p).__name__}, not a tensor")
        if p.dtype != torch.int32:
            raise TypeError(f"plane dtype {p.dtype} is not int32")
        if tuple(p.shape) != shape:
            raise ValueError(f"plane shape {tuple(p.shape)} != {shape}")
        if p.device != device:
            raise ValueError(f"plane on {p.device}, expected {device}")
        if not p.is_contiguous():
            raise ValueError("planes must be contiguous (C, L) int32; call "
                             ".contiguous() on sliced or broadcast planes")


def sorted_union_columnar_fused_lexn(
    keys_a, vals_a, keys_b, vals_b, out_size: int | None = None,
):
    """Fused batched sorted-set union with an N-word lexicographic key.
    Returns (keys_tuple, vals_tuple, n_unique[L]); n_unique is the
    pre-truncation unique count, so overflow (n_unique > out_size) stays
    detectable."""
    keys_a, vals_a, keys_b, vals_b = map(tuple, (keys_a, vals_a, keys_b, vals_b))
    n_keys, n_vals = len(keys_a), len(vals_a)
    if n_keys < 1 or len(keys_b) != n_keys or len(vals_b) != n_vals:
        raise ValueError(
            f"plane counts differ: keys {n_keys}/{len(keys_b)}, "
            f"vals {n_vals}/{len(vals_b)}"
        )
    first = keys_a[0]
    if first.dim() != 2:
        raise ValueError(f"planes must be (C, L), got shape {tuple(first.shape)}")
    c, lanes = first.shape
    if c < 1 or c & (c - 1):
        raise ValueError(f"capacity {c} must be a power of two")
    out = 2 * c if out_size is None else out_size
    if not 0 <= out <= 2 * c:
        raise ValueError(f"out_size {out} outside [0, 2C={2 * c}]")
    _check_planes(keys_a + vals_a + keys_b + vals_b, (c, lanes), first.device)

    if first.device.type == "cpu":
        return _lexn_union_plain(keys_a, vals_a, keys_b, vals_b, out)
    if first.device.type != "cuda":
        raise ValueError(f"no lexn_union kernel for device {first.device}")
    return _lexn_union_cuda(keys_a, vals_a, keys_b, vals_b, out)


def sorted_union_columnar_fused_lex2(
    keys_a, vals_a, keys_b, vals_b, out_size: int | None = None,
):
    """The two-word special case — the OpLog swarm merge
    (``crdt_tpu_torch.models.oplog_columnar``).  Returns
    ((hi, lo), vals_tuple, n_unique[L])."""
    keys, vals, nu = sorted_union_columnar_fused_lexn(
        keys_a, vals_a, keys_b, vals_b, out_size=out_size
    )
    return (keys[0], keys[1]), vals, nu


def _bind(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_crdt_bound", False):
        return
    p = ctypes.c_void_p
    lib.lexn_union.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(p), ctypes.POINTER(p),
        ctypes.POINTER(p), p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p,
    ]
    lib.lexn_union.restype = ctypes.c_int
    lib.lexn_union_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.lexn_union_smem_bytes.restype = ctypes.c_size_t
    lib.lexn_union_error_string.argtypes = [ctypes.c_int]
    lib.lexn_union_error_string.restype = ctypes.c_char_p
    lib._crdt_bound = True


def _lexn_union_cuda(keys_a, vals_a, keys_b, vals_b, out):
    n_keys, n_vals = len(keys_a), len(vals_a)
    if (n_keys, n_vals) not in KERNEL_SPLITS:
        raise ValueError(
            f"lexn_union kernel has no ({n_keys}, {n_vals}) instantiation; "
            f"built splits: {KERNEL_SPLITS}"
        )
    device = keys_a[0].device
    c, lanes = keys_a[0].shape
    outs = [torch.empty((out, lanes), dtype=torch.int32, device=device)
            for _ in range(n_keys + n_vals)]
    nu = torch.empty((lanes,), dtype=torch.int32, device=device)
    if lanes == 0:
        return tuple(outs[:n_keys]), tuple(outs[n_keys:]), nu

    lib = _build.load("lexn_union")
    _bind(lib)

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.lexn_union(
            n_keys, n_vals, ptrs(keys_a + vals_a), ptrs(keys_b + vals_b),
            ptrs(outs), nu.data_ptr(), c, lanes, out, stream,
        )
    if err != 0:
        # a capacity whose shared memory passes the card's opt-in limit
        # (227 KB on Hopper: C <= 4096 at two key and two value planes)
        # fails here, at cudaFuncSetAttribute
        smem = lib.lexn_union_smem_bytes(n_keys, n_vals, c)
        raise RuntimeError(
            f"lexn_union launch failed: {lib.lexn_union_error_string(err).decode()} "
            f"(C={c}, L={lanes}, {smem} B of shared memory per block)"
        )
    LAUNCHES["lexn_union"] += 1
    return tuple(outs[:n_keys]), tuple(outs[n_keys:]), nu


def _lexn_union_plain(keys_a, vals_a, keys_b, vals_b, out):
    """The plain PyTorch twin: stable lexicographic sort of the 2C rows per
    lane, duplicate punch (OR-combine-then-keep-first), compaction by a
    stable sort of the hole flags, truncation to ``out`` rows."""
    n_keys = len(keys_a)
    # rows along the last dim: (L, 2C) views of the concatenated planes
    keys = [torch.cat([a, b], dim=0).T for a, b in zip(keys_a, keys_b)]
    vals = [torch.cat([a, b], dim=0).T for a, b in zip(vals_a, vals_b)]
    keys, vals = _sort_by_keys(keys, vals, n_keys)

    dup = keys[0] != SENTINEL_PY
    for k in keys:
        prev = torch.cat([torch.full_like(k[:, :1], SENTINEL_PY), k[:, :-1]], dim=1)
        dup = dup & (k == prev)
    next_dup = torch.cat([dup[:, 1:], torch.zeros_like(dup[:, :1])], dim=1)
    vals = [torch.where(next_dup, v | torch.roll(v, -1, dims=1), v) for v in vals]
    keys = [k.masked_fill(dup, SENTINEL_PY) for k in keys]

    hole = keys[0] == SENTINEL_PY
    n_unique = (~hole).sum(dim=1, dtype=torch.int32)
    order = torch.sort(hole.to(torch.uint8), dim=1, stable=True).indices
    hole = hole.gather(1, order)
    keys = [k.gather(1, order).masked_fill(hole, SENTINEL_PY) for k in keys]
    vals = [v.gather(1, order).masked_fill(hole, 0) for v in vals]
    return (
        tuple(k[:, :out].T.contiguous() for k in keys),
        tuple(v[:, :out].T.contiguous() for v in vals),
        n_unique,
    )
