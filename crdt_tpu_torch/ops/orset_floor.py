"""The OR-Set union floors: the pass structure of the single-key union
(kernel #2) and of the bucket-local union (kernel #3) with every comparator
replaced by a cheap combine.  A floor's time is what the union's data
movement alone costs; the union's time above it is the most a better
comparator could win without changing that structure.

Counterpart of ``benches/orset_floor.py`` (``floor_union``,
``bucketed_floor_union``); the kernels are ``csrc/set_floor.cu``.  Both are
deterministic int32 functions of their inputs.  Per lane, over the 2C rows
"A ++ B reversed" (B reversed within each bucket of Wb rows for the
bucketed floor, whose passes run per 2·Wb-row segment):

1. butterfly stages at strides S/2 .. 1 (S = 2C, or 2·Wb), keys
   ``(a + b, a - b)``, values ``(a | b, a ^ b)``;
2. the punch: ``keys += shift_down(keys, 1, SENTINEL)``,
   ``vals |= shift_up(vals, 1, 0)``, ``keys ^= shift_up(keys, 1, 0)``
   (over the whole lane, across segments);
3. ``p`` = the inclusive prefix count of ``keys & 1``;
   ``disp = p | vals << 16``; ``nu = p`` at the lane's last row;
4. a suffix sum of ``keys`` and a suffix OR of ``disp``;
5. the first ``out_size`` rows (the first Wb of each segment) as keys and
   ``disp >> 16`` as values.

Sums wrap mod 2^32, as XLA's int32 does.  Planes are (C, L) int32, C a
power of two; the outputs are (out, L), (out, L) and (1, L).

Dispatch as :mod:`crdt_tpu_torch.ops.hopper_union`: a CPU tensor runs the
plain twin, a CUDA tensor launches the kernel (or raises); launches are
counted in ``hopper_union.LAUNCHES``.
"""
from __future__ import annotations

import torch

from crdt_tpu_torch.ops import hopper_union as hu
from crdt_tpu_torch.utils.constants import SENTINEL_PY

FLAG_SHIFT = 16  # the displacement word's value field (pallas_union.FLAG_SHIFT)


def _check(keys_a, vals_a, keys_b, vals_b):
    """(C, L) of four matching (C, L) int32 contiguous planes, C a power
    of two."""
    if not isinstance(keys_a, torch.Tensor) or keys_a.dim() != 2:
        raise ValueError("planes must be (C, L) int32 tensors")
    c, lanes = keys_a.shape
    if c < 1 or c & (c - 1):
        raise ValueError(f"capacity {c} must be a power of two")
    hu._check_planes((keys_a, vals_a, keys_b, vals_b), (c, lanes), keys_a.device)
    return c, lanes


def floor_union(keys_a, vals_a, keys_b, vals_b, out_size: int):
    """Kernel #2's pass structure with free combines over one 2C-row
    segment a lane.  Returns (keys[out, L], vals[out, L], nu[1, L])."""
    c, _ = _check(keys_a, vals_a, keys_b, vals_b)
    if not 0 <= out_size <= 2 * c:
        raise ValueError(f"out_size {out_size} outside [0, 2C={2 * c}]")
    if hu._route("floor_union", keys_a.device):
        return _floor_plain(keys_a, vals_a, torch.flip(keys_b, dims=(0,)),
                            torch.flip(vals_b, dims=(0,)), c, out_size)
    return _floor_cuda("floor_union", keys_a, vals_a, keys_b, vals_b, c, out_size)


def bucketed_floor_union(keys_a, vals_a, keys_b, vals_b, n_buckets: int):
    """Kernel #3's pass structure with free combines: ``n_buckets``
    segments of 2·Wb rows a lane, Wb = C / n_buckets rows of each kept.
    Returns (keys[C, L], vals[C, L], nu[1, L]), nu the last segment's
    count."""
    c, _ = _check(keys_a, vals_a, keys_b, vals_b)
    if n_buckets < 1 or c % n_buckets:
        raise ValueError(f"{n_buckets} buckets must divide C={c}")
    wb = c // n_buckets  # a power of two, as C is
    if hu._route("bucketed_floor_union", keys_a.device):
        return _floor_plain(keys_a, vals_a, _flip_buckets(keys_b, n_buckets),
                            _flip_buckets(vals_b, n_buckets), wb, wb)
    return _floor_cuda("bucketed_floor_union", keys_a, vals_a, keys_b, vals_b, wb, wb)


def _flip_buckets(x, n_buckets):
    """B reversed within each bucket (``pallas_union._flip_buckets``)."""
    c, lanes = x.shape
    return torch.flip(x.reshape(n_buckets, c // n_buckets, lanes), dims=(1,)).reshape(c, lanes)


# ---- the kernel ----
#
# csrc/set_floor.cu's two bodies and their plans: pure functions of the
# shape and the card's shared-memory limit (the CPU tests plan with
# hopper_union.HOPPER_SMEM_OPTIN).

# the tile body (kernel 7): threads a CTA, rows of a lane a thread holds
# (at most), plane buffers in its ring
FLOOR_THREADS = 512
FLOOR_ROWS = 32
FLOOR_RING = 3
# the segment walk (kernel 8): a segment of 2·Wb rows in registers, 256
# lanes a CTA (set_floor.cu WalkArgs::width; 1 KB row requests)
FLOOR_WALK_MAX_WB = 16
FLOOR_WALK_LANES = 256


def floor_tile_plan(c: int) -> tuple[int, int, int]:
    """(lanes a tile, rows a thread, shared-memory bytes a CTA) of the tile
    body at ``c`` rows an operand: R = min(32, 2C) rows a thread, 512 threads
    hold a tile of 512·R / 2C lanes; three plane buffers of 512·R words and
    four 512-word arrays (edge rows, scan totals).  Past the envelope (C >
    8,192) the tile would be one lane whose ring holds three whole columns:
    that figure, past the card's limit, is what the refused launch reports."""
    n = 2 * c
    rows = min(FLOOR_ROWS, n)
    lanes = max(1, FLOOR_THREADS * rows // n)
    plane_words = max(FLOOR_THREADS * rows, n)
    return lanes, rows, 4 * (FLOOR_RING * plane_words + 4 * FLOOR_THREADS)


def bucketed_floor_plan(c: int, n_buckets: int, limit: int) -> tuple:
    """The bucketed floor's body and plan on a card with ``limit`` bytes a
    block: ``("walk", lanes a CTA, bucket buffers, bytes)`` where a segment
    of 2·Wb rows fits the walk's registers (Wb <= 16) — 256 lanes and as
    many buffers of one bucket's four planes as fit, up to kernel 3's
    ``SEGMENT_MAX_STAGES`` and never more than the buckets, at least two
    where there are two (the next bucket loads while this one is computed)
    — else ``("tile", lanes a tile, rows a thread, bytes)``, the tile body
    at segments of Wb rows."""
    wb = c // n_buckets
    if wb > FLOOR_WALK_MAX_WB:
        return ("tile", *floor_tile_plan(c))
    per_stage = 4 * 4 * wb * FLOOR_WALK_LANES
    stages = max(min(2, n_buckets), min(hu.SEGMENT_MAX_STAGES, n_buckets, limit // per_stage))
    return "walk", FLOOR_WALK_LANES, stages, stages * per_stage


def _floor_cuda(name, keys_a, vals_a, keys_b, vals_b, seg, out_seg):
    """Launch csrc/set_floor.cu for entry point ``name`` with segments of
    ``seg`` rows an operand, ``out_seg`` rows of each kept: floor_union on
    the tile body, bucketed_floor_union on the body of its plan."""
    device = keys_a.device
    c, lanes = keys_a.shape
    rows_out = c // seg * out_seg
    ko = torch.empty((rows_out, lanes), dtype=torch.int32, device=device)
    vo = torch.empty((rows_out, lanes), dtype=torch.int32, device=device)
    nu = torch.empty((1, lanes), dtype=torch.int32, device=device)
    limit = hu.smem_limit(device)
    if name == "floor_union":
        plan = ("tile", *floor_tile_plan(c))
    else:
        plan = bucketed_floor_plan(c, c // seg, limit)
    if lanes == 0:
        return ko, vo, nu
    lib = hu._lib("set_floor")
    args = (keys_a.data_ptr(), vals_a.data_ptr(), keys_b.data_ptr(), vals_b.data_ptr(),
            ko.data_ptr(), vo.data_ptr(), nu.data_ptr(), c, lanes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if plan[0] == "tile":
            _, lane_tile, rows, smem = plan
            err = lib.floor_union(*args, seg, out_seg, lane_tile, smem, stream)
            what = f"tile body, {lane_tile} lanes a tile, {rows} rows a thread"
        else:
            _, width, stages, smem = plan
            err = lib.bucketed_floor_walk(*args, seg, stages, smem, stream)
            what = f"segment walk, {width} lanes a CTA, {stages} bucket buffers"
    if err != 0:
        # past C = 8,192 the tile body has no plan (its figure exceeds the
        # card's opt-in limit), and the launcher refuses it
        raise RuntimeError(
            f"{name} launch failed: {lib.set_floor_error_string(err).decode()} "
            f"(C={c}, L={lanes}; {what}: {smem} B of shared memory per block, "
            f"{limit} B allowed)"
        )
    hu.LAUNCHES[name] += 1
    return ko, vo, nu


# ---- the plain twin ----
#
# The TPU kernels' passes as they are written there, over (2C, L) planes:
# reshapes for the butterflies, shifted copies for the punch and log2-step
# (Hillis-Steele) scans.


def _shift(x, s, fill, seg, up):
    """Within each ``seg``-row segment, x[i] := x[i + s] (``up``) or
    x[i - s], the rows shifted in filled."""
    lanes = x.shape[1]
    r = x.reshape(-1, seg, lanes)
    pad = torch.full((r.shape[0], s, lanes), fill, dtype=x.dtype, device=x.device)
    out = torch.cat([r[:, s:], pad] if up else [pad, r[:, :-s]], dim=1)
    return out.reshape(x.shape)


def _floor_plain(keys_a, vals_a, keys_br, vals_br, seg, out_seg):
    """The floor over segments of ``seg`` rows an operand, B already
    reversed per segment; ``out_seg`` rows of each 2·seg-row merged segment
    kept."""
    c, lanes = keys_a.shape
    nb, n, seg2 = c // seg, 2 * c, 2 * seg

    def interleave(a, b):  # segment i of A ++ segment i of B
        return torch.cat([a.reshape(nb, seg, lanes), b.reshape(nb, seg, lanes)],
                         dim=1).reshape(n, lanes)

    keys, vals = interleave(keys_a, keys_br), interleave(vals_a, vals_br)
    # strictly from the widest stride down: the value stages do not commute
    stride = seg
    while stride >= 1:
        rk = keys.reshape(n // (2 * stride), 2, stride, lanes)
        rv = vals.reshape(n // (2 * stride), 2, stride, lanes)
        keys = torch.stack([rk[:, 0] + rk[:, 1], rk[:, 0] - rk[:, 1]], dim=1).reshape(n, lanes)
        vals = torch.stack([rv[:, 0] | rv[:, 1], rv[:, 0] ^ rv[:, 1]], dim=1).reshape(n, lanes)
        stride //= 2
    keys = keys + _shift(keys, 1, SENTINEL_PY, n, up=False)
    vals = vals | _shift(vals, 1, 0, n, up=True)
    keys = keys ^ _shift(keys, 1, 0, n, up=True)
    p = keys & 1
    s = 1
    while s < seg2:
        p = p + _shift(p, s, 0, seg2, up=False)
        s *= 2
    disp = p | (vals << FLAG_SHIFT)
    nu = p[n - 1:n].clone()
    s = 1
    while s < seg2:
        keys = keys + _shift(keys, s, 0, seg2, up=True)
        disp = disp | _shift(disp, s, 0, seg2, up=True)
        s *= 2

    def head(x):  # the first out_seg rows of each merged segment
        return x.reshape(nb, seg2, lanes)[:, :out_seg].reshape(nb * out_seg, lanes)

    return head(keys).contiguous(), (head(disp) >> FLAG_SHIFT).contiguous(), nu
