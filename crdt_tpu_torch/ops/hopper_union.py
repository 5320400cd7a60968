"""Columnar sorted-set unions and merge: the hand-written Hopper kernels and
their plain PyTorch twins.

Counterpart of ``crdt_tpu.ops.pallas_union``.  Two CUDA sources:

* ``csrc/lexn_union.cu`` — the fused lexN union
  (``sorted_union_columnar_fused_lexn`` / ``_lex2``, the OpLog swarm's
  merge), duplicates OR-combined into the kept copy
  (OR-combine-then-keep-first);
* ``csrc/set_union.cu`` — the single-key OR-Set union
  (``sorted_union_columnar_fused``), its merge stage alone
  (``bitonic_merge_columnar``) and the bucket-local union
  (``bucketed_union_columnar``).

The host contract is the JAX one: planes are ``(C, L)`` int32 with lane j
holding one replica's rows, per-lane sorted ascending over the key words,
padding rows SENTINEL in every key word and 0 in every value plane; C is a
power of two.  A union returns the smallest ``out_size`` rows of the union
(SENTINEL / 0 past the unique count) and the pre-truncation ``n_unique``
per lane.  A row whose key is SENTINEL is padding, value included.  Lane
counts need no multiple of 128: that tile was the TPU's.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor runs
the plain twin.  There is no fallback from one to the other.  ``LAUNCHES``
counts kernel launches by kernel name.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from crdt_tpu_torch import _build
from crdt_tpu_torch.ops.sorted_union import _sort_by_keys
from crdt_tpu_torch.utils.constants import SENTINEL_PY

LAUNCHES = {"lexn_union": 0, "set_union": 0, "merge": 0, "bucketed_union": 0}

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


def _route(name: str, device: torch.device) -> bool:
    """True for the CPU twin, False for the CUDA kernel; raises otherwise."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {device}")
    return False


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

    if _route("lexn_union", first.device):
        return _lexn_union_plain(keys_a, vals_a, keys_b, vals_b, out)
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


_P = ctypes.c_void_p
_I = ctypes.c_int
# the C entry points of each csrc/<name>.cu: (argtypes, restype)
_SIGNATURES = {
    "lexn_union": {
        "lexn_union": ([_I, _I, ctypes.POINTER(_P), ctypes.POINTER(_P),
                        ctypes.POINTER(_P), _P, _I, _I, _I, _P], _I),
        "lexn_union_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
        "lexn_union_error_string": ([_I], ctypes.c_char_p),
    },
    "set_union": {
        "set_union": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "set_union_smem_bytes": ([_I, _I], ctypes.c_size_t),
        "set_union_lane_tile": ([_I, _I], _I),
        "set_union_error_string": ([_I], ctypes.c_char_p),
    },
}


def _lib(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its C signatures bound."""
    lib = _build.load(name)
    if not getattr(lib, "_crdt_bound", False):
        for fn, (args, res) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        lib._crdt_bound = True
    return lib


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

    lib = _lib("lexn_union")

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


# ---- single-key OR-Set union, its merge stage, the bucket-local union ----
#
# csrc/set_union.cu in two modes: UNION over segments of `seg` rows (the
# whole lane, or the Wb rows of a bucket), each cut to `out_seg` rows, and
# MERGE.  Values are OR-combined on duplicate keys (the OR-Set tombstone
# rule); the TPU kernels took values < 2^15 only, the port any int32.

_UNION, _MERGE = 0, 1


def _check_columnar(keys_a, vals_a, keys_b, vals_b, pow2: bool = True):
    """(C, L) of four matching planes; C must be a power of two for the
    full-lane union and merge (the bucketed layout needs only a
    power-of-two bucket width)."""
    if not isinstance(keys_a, torch.Tensor) or keys_a.dim() != 2:
        raise ValueError("planes must be (C, L) int32 tensors")
    c, lanes = keys_a.shape
    if pow2 and (c < 1 or c & (c - 1)):
        raise ValueError(f"capacity {c} must be a power of two")
    _check_planes((keys_a, vals_a, keys_b, vals_b), (c, lanes), keys_a.device)
    return c, lanes


def _out_rows(c: int, out_size) -> int:
    out = 2 * c if out_size is None else out_size
    if not 0 <= out <= 2 * c:
        raise ValueError(f"out_size {out} outside [0, 2C={2 * c}]")
    return out


def sorted_union_columnar_fused(keys_a, vals_a, keys_b, vals_b,
                                out_size: int | None = None):
    """Batched single-key sorted-set union, values OR-combined on duplicate
    keys (kernel #2's contract).  Returns (keys[out, L], vals[out, L],
    n_unique[L]); n_unique is counted before truncation."""
    c, _ = _check_columnar(keys_a, vals_a, keys_b, vals_b)
    out = _out_rows(c, out_size)
    if _route("set_union", keys_a.device):
        return _set_union_plain(keys_a, vals_a, keys_b, vals_b, out)
    return _set_union_cuda("set_union", keys_a, vals_a, keys_b, vals_b, c, out)


def sorted_union_columnar(keys_a, vals_a, keys_b, vals_b,
                          out_size: int | None = None):
    """The OR-Set columnar union (the ``sort`` engine): the fused kernel."""
    return sorted_union_columnar_fused(keys_a, vals_a, keys_b, vals_b,
                                       out_size=out_size)


def bitonic_merge_columnar(keys_a, vals_a, keys_b, vals_b):
    """Merge only (kernel #6): lane j of the (2C, L) output is the sorted
    merge of a[:, j] and b[:, j], nothing dropped; of two equal keys A's
    copy comes first (the TPU's bitonic network left that order open).
    Returns (keys, vals)."""
    c, _ = _check_columnar(keys_a, vals_a, keys_b, vals_b)
    if _route("merge", keys_a.device):
        return _merge_plain(keys_a, vals_a, keys_b, vals_b)
    return _set_union_cuda("merge", keys_a, vals_a, keys_b, vals_b, c, 2 * c)


def sorted_union_columnar_unfused(keys_a, vals_a, keys_b, vals_b,
                                  out_size: int | None = None):
    """Two-pass union: the merge kernel, then the dedupe-and-compact
    epilogue in plain torch — the A/B reference for the fused union."""
    c, _ = _check_columnar(keys_a, vals_a, keys_b, vals_b)
    out = _out_rows(c, out_size)
    ko, vo = bitonic_merge_columnar(keys_a, vals_a, keys_b, vals_b)
    return _dedupe_and_compact(ko, vo, out)


def _bucketed_check(keys_a, n_buckets: int, out_bucket_rows):
    c, lanes = keys_a.shape
    wb = c // n_buckets
    if wb * n_buckets != c:
        raise ValueError(f"{n_buckets} buckets must divide C={c}")
    if wb & (wb - 1):
        raise ValueError(f"bucket width {wb} must be a power of two")
    out_r = out_bucket_rows if out_bucket_rows is not None else wb
    if not 0 <= out_r <= 2 * wb:
        raise ValueError(
            f"out_bucket_rows {out_r} exceeds the lossless 2·Wb={2 * wb} bound")
    return wb, out_r, lanes


def bucketed_union_columnar(keys_a, vals_a, keys_b, vals_b, n_buckets: int,
                            out_bucket_rows: int | None = None):
    """Bucket-local union (kernel #3): operands and output in the bucketed
    layout (B segments of Wb rows, each ascending with its own SENTINEL
    tail); each bucket's union is cut to ``out_bucket_rows`` (default Wb).
    Returns (keys[B·out, L], vals[B·out, L], n_unique[L], bucket_max[L]):
    the per-lane sum and maximum of the buckets' unique counts before
    truncation."""
    _check_columnar(keys_a, vals_a, keys_b, vals_b, pow2=False)
    wb, out_r, _ = _bucketed_check(keys_a, n_buckets, out_bucket_rows)
    if _route("bucketed_union", keys_a.device):
        return _bucketed_union_plain(keys_a, vals_a, keys_b, vals_b, n_buckets, out_r)
    return _set_union_cuda("bucketed_union", keys_a, vals_a, keys_b, vals_b, wb, out_r)


def _set_union_cuda(name, keys_a, vals_a, keys_b, vals_b, seg, out_seg):
    """Launch csrc/set_union.cu: ``name`` is "set_union" (one segment),
    "bucketed_union" (segments of Wb rows, with bucket_max) or "merge"."""
    device = keys_a.device
    c, lanes = keys_a.shape
    mode = _MERGE if name == "merge" else _UNION
    rows_out = c // seg * out_seg

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)

    ko, vo = empty(rows_out, lanes), empty(rows_out, lanes)
    nu = empty(lanes) if mode == _UNION else None
    bmax = empty(lanes) if name == "bucketed_union" else None
    outs = tuple(t for t in (ko, vo, nu, bmax) if t is not None)
    if lanes == 0:
        return outs

    lib = _lib("set_union")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.set_union(
            mode, keys_a.data_ptr(), vals_a.data_ptr(), keys_b.data_ptr(),
            vals_b.data_ptr(), ko.data_ptr(), vo.data_ptr(),
            None if nu is None else nu.data_ptr(),
            None if bmax is None else bmax.data_ptr(),
            c, lanes, seg, out_seg, stream,
        )
    if err != 0:
        # past the card's shared-memory opt-in (227 KB on Hopper: C = 16,384
        # at one lane per block) cudaFuncSetAttribute refuses the launch
        raise RuntimeError(
            f"{name} launch failed: {lib.set_union_error_string(err).decode()} "
            f"(C={c}, L={lanes}, {lib.set_union_smem_bytes(c, rows_out)} B of shared "
            f"memory per block at {lib.set_union_lane_tile(c, rows_out)} lanes a block)"
        )
    LAUNCHES[name] += 1
    return outs


def _set_union_plain(keys_a, vals_a, keys_b, vals_b, out):
    """Kernel #2's plain twin: the lexN union's twin at one key word and one
    value plane."""
    keys, vals, nu = _lexn_union_plain((keys_a,), (vals_a,), (keys_b,), (vals_b,), out)
    return keys[0], vals[0], nu


def _merge_plain(keys_a, vals_a, keys_b, vals_b):
    """Kernel #6's plain twin: a stable sort of the 2C rows per lane (A's
    rows first, so A's copy of an equal key stays first), values carried."""
    keys, order = torch.sort(torch.cat([keys_a, keys_b], dim=0), dim=0, stable=True)
    return keys, torch.cat([vals_a, vals_b], dim=0).gather(0, order)


def _bucketed_union_plain(keys_a, vals_a, keys_b, vals_b, n_buckets, out_r):
    """Kernel #3's plain twin: each (bucket, lane) pair is one lane of the
    union twin, cut to ``out_r`` rows."""
    c, lanes = keys_a.shape
    wb = c // n_buckets

    def as_lanes(x):  # (C, L) -> (Wb, B·L): column b·L + j is bucket b of lane j
        return x.reshape(n_buckets, wb, lanes).permute(1, 0, 2).reshape(wb, -1)

    def as_planes(x):  # (out_r, B·L) -> (B·out_r, L)
        return x.reshape(out_r, n_buckets, lanes).permute(1, 0, 2).reshape(-1, lanes)

    keys, vals, nu = _set_union_plain(*map(as_lanes, (keys_a, vals_a, keys_b, vals_b)), out_r)
    nu = nu.reshape(n_buckets, lanes)
    return (as_planes(keys), as_planes(vals), nu.sum(dim=0, dtype=torch.int32),
            nu.amax(dim=0))


def _dedupe_and_compact(keys, vals, out_size):
    """Plain epilogue on merged-sorted (2C, L) columns: OR each adjacent
    duplicate's values into the first copy, punch the second copy to
    SENTINEL, sink the punched rows with one stable sort."""
    above = torch.cat([keys[:1] - 1, keys[:-1]], dim=0)
    dup = keys == above
    below_dup = torch.cat([dup[1:], torch.zeros_like(dup[:1])], dim=0)
    vals_below = torch.cat([vals[1:], vals[:1]], dim=0)
    vals = torch.where(below_dup, vals | vals_below, vals)
    keys, order = torch.sort(keys.masked_fill(dup, SENTINEL_PY), dim=0, stable=True)
    pad = keys == SENTINEL_PY
    vals = vals.gather(0, order).masked_fill(pad, 0)
    n_unique = (~pad).sum(dim=0, dtype=torch.int32)
    return keys[:out_size].contiguous(), vals[:out_size].contiguous(), n_unique
