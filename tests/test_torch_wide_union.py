"""The wide body of the fused lexN union (csrc/lexn_union.cu
``wide_union_kernel``, kernel 1 at keys the lane tile does not take): its
plans and shared-memory figures at the H100's 232,448 B a block, each
against a part-by-part count, and the route each shape takes; then a
plain numpy rehearsal of the body's walk — the per-CTA row split of the
staging, merge-path co-ranks at K rows a thread, flags read through the
map, the block scan, the compacted gather map with its duplicate bit, and
the move with its fill — held bit for bit against the plain twin
(``_lexn_union_plain``) and against the JAX package's
``sorted_union_columnar_fused_lexn`` in interpret mode.  The kernel itself
is held against the twin on the card by test_torch_rseq_cuda.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.ops import pallas_union as pu
from crdt_tpu_torch.ops import hopper_union as hu

S = 2**31 - 1
LIMIT = hu.HOPPER_SMEM_OPTIN
TILE = 8          # lanes of a cluster, CTAs of a cluster
RANK_ROWS = 2     # merged rows a thread takes at least
MAX_RANK_ROWS = 8
LANES = 17        # lanes a case draws; a rehearsal takes the first L


# ---- (a) plans and shared memory ----


def wide_bytes(n_keys, c):
    """The wide body's shared memory a CTA, counted part by part: both
    operands' key rows of the CTA's lane (n_keys rounded up to 4 words),
    the map (a word a merged row), the scan's 32 warp sums, a flag byte a
    merged row."""
    kp = -(-n_keys // 4) * 4
    keys = 2 * c * kp * 4
    gather_map = 2 * c * 4
    sums = 32 * 4
    flags = 2 * c
    return keys + gather_map + sums + flags


@pytest.mark.parametrize("n_keys, n_vals, c, body, smem, route", [
    (18, 2, 512, (8, 0, 2), 87_168, None),     # RSeq's (18, .) at C = 512: two CTAs an SM
    (18, 3, 512, (8, 0, 2), 87_168, None),
    (18, 2, 1024, (8, 0, 1), 174_208, None),   # at C = 1024: fused, one CTA an SM
    (18, 3, 1024, (8, 0, 1), 174_208, None),
    (18, 2, 2048, (8, 0, 1), 348_288, 1024),   # past the card: stripes at S = 1024
    (18, 3, 2048, (8, 0, 1), 348_288, 1024),
    (2, 2, 2048, (8, 0, 2), 86_144, None),     # the OpLog's split past the tile
    (2, 2, 4096, (8, 0, 1), 172_160, None),
    (2, 2, 8192, (8, 0, 1), 344_192, 4096),
    (5, 2, 64, (8, 0, 8), 4_864, None),        # past the tile's 4 key words: eight CTAs an SM
    (18, 2, 256, (8, 0, 4), 43_648, None),
])
def test_wide_body_plan_at_the_h100_limit(n_keys, n_vals, c, body, smem, route):
    assert hu.lexn_union_body(n_keys, n_vals, c, 2 * c, LIMIT) == body
    assert hu.lexn_union_smem_bytes(n_keys, n_vals, c) == smem == wide_bytes(n_keys, c)
    assert hu.lexn_wide_smem_bytes(n_keys, c) == smem
    assert hu.lexn_fits(c, n_keys, n_vals, LIMIT) == (route is None) == (smem <= LIMIT)
    assert hu.lexn_plan(c, n_keys, n_vals, LIMIT) == route
    # the most CTAs an SM (of 8, 4, 2, 1) whose shared memory fits its
    # 228 KB, 1 KB reserved a CTA; 1,024 threads shared among them
    assert body[2] == next((k for k in (8, 4, 2) if k * (smem + 1024) <= 228 * 1024), 1)
    assert hu.wide_threads(body) == 1024 // body[2]
    if route is None:
        assert 2 * c <= MAX_RANK_ROWS * hu.wide_threads(body)


@pytest.mark.parametrize("n_keys", [1, 2, 3, 4, 5, 6, 9, 18, 24, 29])
def test_wide_body_rows_fit_its_threads_wherever_it_fits(n_keys):
    """Wherever the wide body fits the card, its 2C merged rows fit its
    threads at 8 rows each (the launcher's check), and where the tile body
    takes the shape the wide body is not named."""
    for c in (1 << k for k in range(3, 15)):
        for n_vals in (1, 2, 3):
            if n_keys + n_vals > hu.MAX_PLANES:
                continue
            body = hu.lexn_union_body(n_keys, n_vals, c, 2 * c, LIMIT)
            if body[1]:
                assert n_keys <= hu.TILE_MAX_KEYS
                continue
            fits = hu.lexn_wide_smem_bytes(n_keys, c) <= LIMIT
            assert hu.lexn_fits(c, n_keys, n_vals, LIMIT) == fits
            if fits:
                assert 2 * c <= MAX_RANK_ROWS * hu.wide_threads(body)


# ---- (b) the walk, rehearsed ----


def draw(n_keys, c, case, seed):
    """(ka, va, kb, vb) numpy planes of LANES lanes for one case: each lane
    a seeded subset of one universe of distinct n_keys-word keys (word 0
    never SENTINEL, full-range int32 otherwise), ascending, SENTINEL/0
    padded; two value planes of full-range int32, drawn apart for the
    sides, so that a duplicate's OR shows."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2**31, 2**31 - 1, (6 * c, n_keys))
    if case == "ties":
        words[:, 0] = rng.integers(0, 4, 6 * c)   # many keys tie on word 0
    else:
        words[:, 0] = rng.integers(-2**31, 2**31 - 1, 6 * c)
        words[: c // 4, :-1] = words[0, :-1]      # and some tie on every word but the last
    universe = np.unique(words, axis=0)
    size = {"overflow": 3 * c}.get(case, 2 * c)
    universe = universe[np.sort(rng.choice(len(universe), size, replace=False))]

    def side(picks):
        keys = np.full((n_keys, c, LANES), S, np.int32)
        vals = np.zeros((2, c, LANES), np.int32)
        for lane, rows in enumerate(picks):
            rows = np.sort(rows)[:c]
            keys[:, :len(rows), lane] = universe[rows].T
            vals[:, :len(rows), lane] = rng.integers(-2**31, 2**31 - 1, (2, len(rows)))
        return keys, vals

    fill = {"overflow": 1.0}.get(case, 0.6)
    picks_a = [rng.choice(size, int(fill * c), replace=False) for _ in range(LANES)]
    if case == "inside":
        picks_b = [rng.choice(p, len(p) // 2, replace=False) for p in picks_a]
    else:
        picks_b = [rng.choice(size, int(fill * c), replace=False) for _ in range(LANES)]
    if case == "padding":
        for lane in (0, 5, 8, LANES - 1):          # all padding on both sides
            picks_a[lane] = picks_b[lane] = np.zeros(0, np.int64)
    ka, va = side(picks_a)
    kb, vb = side(picks_b)
    return ka, va, kb, vb


def rehearse(ka, va, kb, vb, out, threads):
    """The wide body's walk in numpy, tile by tile and CTA by CTA as the
    kernel splits it.  Returns (keys, vals, n_unique) like the twin, and
    asserts on the way that staging and the move touch every row once."""
    n_keys, c, lanes = ka.shape
    n, kp, groups = 2 * c, -(-n_keys // 4) * 4, threads // TILE
    k_rows = max(RANK_ROWS, -(-n // threads))
    assert k_rows <= MAX_RANK_ROWS
    keys_out = np.empty((n_keys, out, lanes), np.int32)
    vals_out = np.empty((va.shape[0], out, lanes), np.int32)
    nu_out = np.empty(lanes, np.int32)
    for l0 in range(0, lanes, TILE):
        # 1. staging: CTA `me` takes rows [r0, r0 + nr) of every lane of the
        # tile, item (side, quad, row), into the owner's rows (A's, then B's)
        staged = np.zeros((TILE, n, kp), np.int32)
        writes = np.zeros((TILE, n, kp // 4), np.int32)
        per = -(-c // TILE)
        for me in range(TILE):
            r0 = min(c, me * per)
            nr = min(c, r0 + per) - r0
            quads = kp // 4
            for l in range(TILE):
                if l0 + l >= lanes:
                    continue
                for g in range(groups):
                    for w in range(g, 2 * quads * nr, groups):
                        r, q, sd = r0 + w % nr, (w // nr) % quads, w // (nr * quads)
                        src = kb if sd else ka
                        for u in range(4):
                            k = 4 * q + u
                            staged[l, sd * c + r, k] = src[k, r, l0 + l] if k < n_keys else 0
                        writes[l, sd * c + r, q] += 1
        owners = [l for l in range(TILE) if l0 + l < lanes]
        assert (writes[owners] == 1).all() and not writes[len(owners):].any()

        gather, nu = {}, {}
        for l in owners:
            rows = [tuple(int(x) for x in staged[l, i]) for i in range(n)]
            # 2. rank by merge path, K rows a thread, and flag each row
            mp, flag = np.zeros(n, np.int32), np.zeros(n, np.int32)
            for t in range(threads):
                d0 = min(n, t * k_rows)
                d1 = min(n, d0 + k_rows)
                if d0 >= d1:
                    continue
                lo, hi = max(0, d0 - c), min(d0, c)
                while lo < hi:
                    mid = (lo + hi) // 2
                    if not rows[c + d0 - mid - 1] < rows[mid]:
                        lo = mid + 1
                    else:
                        hi = mid
                ia, ib = lo, d0 - lo
                prev = None
                if d0 > 0:  # the later of A[ia - 1], B[ib - 1]
                    pa = rows[ia - 1] if ia else None
                    pb = rows[c + ib - 1] if ib else None
                    prev = pa if ib == 0 else pb if ia == 0 else (pa if pb < pa else pb)
                for d in range(d0, d1):
                    take_a = ia < c and (ib >= c or not rows[c + ib] < rows[ia])
                    src = ia if take_a else c + ib
                    ia, ib = (ia + 1, ib) if take_a else (ia, ib + 1)
                    mp[d] = src
                    flag[d] = 2 if rows[src][0] == S else int(prev == rows[src])
                    prev = rows[src]
            # 3. each thread reads its run and the next run's first entry,
            # then the scan; the map is rewritten in place
            reads, counts = [], []
            for t in range(threads):
                d0 = min(n, t * k_rows)
                d1 = min(n, d0 + k_rows)
                inside = [k <= k_rows and d0 + k < n for k in range(MAX_RANK_ROWS + 1)]
                src = [int(mp[d0 + k]) if inside[k] else 0 for k in range(MAX_RANK_ROWS + 1)]
                fl = [int(flag[d0 + k]) if inside[k] else 2 for k in range(MAX_RANK_ROWS + 1)]
                counts.append(sum(k < k_rows and d0 + k < d1 and fl[k] == 0
                                  for k in range(MAX_RANK_ROWS)))
                reads.append((d0, d1, src, fl))
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            for (d0, d1, src, fl), dst in zip(reads, starts):
                for k in range(MAX_RANK_ROWS):
                    if k < k_rows and d0 + k < d1 and fl[k] == 0:
                        entry = src[k] | (src[k + 1] << 16 | 1 << 31 if fl[k + 1] == 1 else 0)
                        mp[dst] = np.int64(entry).astype(np.int32)
                        dst += 1
            gather[l], nu[l] = mp, int(sum(counts))
            nu_out[l0 + l] = nu[l]

        # 4. the move: CTA `me` writes rows [o0, o1) of the tile's lanes
        moved = np.zeros((out, TILE), np.int32)
        per = -(-out // TILE)
        for me in range(TILE):
            o0 = min(out, me * per)
            o1 = min(out, o0 + per)
            for l in owners:
                lane = l0 + l
                for g in range(groups):
                    for o in range(o0 + g, o1, groups):
                        moved[o, l] += 1
                        if o >= nu[l]:
                            keys_out[:, o, lane], vals_out[:, o, lane] = S, 0
                            continue
                        e = gather[l][o]
                        s0 = int(e & 0xFFFF)
                        keys_out[:, o, lane] = staged[l, s0, :n_keys]
                        x = (va if s0 < c else vb)[:, s0 % c, lane].copy()
                        if e < 0:
                            s1 = int((e >> 16) & 0x7FFF)
                            x |= (va if s1 < c else vb)[:, s1 % c, lane]
                        vals_out[:, o, lane] = x
        assert (moved[:, :len(owners)] == 1).all()
    return keys_out, vals_out, nu_out


def twin(ka, va, kb, vb, out):
    t = [tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in side) for side in (ka, va, kb, vb)]
    keys, vals, nu = hu.sorted_union_columnar_fused_lexn(*t, out_size=out)
    return keys.numpy(), vals.numpy(), nu.numpy()


CASES = ("ties", "padding", "inside", "overflow")


@functools.lru_cache(maxsize=None)
def jax_union(n_keys, c):
    """The Pallas kernel in interpret mode at out = 2C over every case's
    lanes side by side (padded to its 128-lane tile with padding lanes):
    {case: (keys, vals, n_unique)} of LANES lanes each."""
    draws = [draw(n_keys, c, case, seed=c * 10 + n_keys) for case in CASES]
    pad = pu.LANES - LANES * len(CASES)

    def planes(i, fill):
        cat = np.concatenate([d[i] for d in draws], axis=2)
        cat = np.pad(cat, ((0, 0), (0, 0), (0, pad)), constant_values=fill)
        return tuple(jnp.asarray(p) for p in cat)

    keys, vals, nu = pu.sorted_union_columnar_fused_lexn(
        planes(0, S), planes(1, 0), planes(2, S), planes(3, 0), out_size=2 * c,
        interpret=True)
    keys, vals, nu = np.stack(keys), np.stack(vals), np.asarray(nu).reshape(-1)
    return {case: (keys[..., i * LANES:(i + 1) * LANES], vals[..., i * LANES:(i + 1) * LANES],
                   nu[i * LANES:(i + 1) * LANES]) for i, case in enumerate(CASES)}


@pytest.mark.parametrize("out_of", ["C/2", "C", "2C"])
@pytest.mark.parametrize("lanes", [1, 3, 9, 17])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("c", [8, 16, 32, 64])
@pytest.mark.parametrize("n_keys", [3, 6])
def test_rehearsed_walk_matches_the_twin_and_pallas(n_keys, c, case, lanes, out_of):
    """16 threads a CTA (two groups of 8), so that a lane's 2C rows span
    many runs of K = 2 (C = 8, 16), 4 (C = 32) and 8 (C = 64) rows."""
    out = {"C/2": c // 2, "C": c, "2C": 2 * c}[out_of]
    ka, va, kb, vb = (x[..., :lanes] for x in draw(n_keys, c, case, seed=c * 10 + n_keys))
    got = rehearse(ka, va, kb, vb, out, threads=16)
    want = twin(ka, va, kb, vb, out)
    jk, jv, jn = jax_union(n_keys, c)[case]
    for g, w, j in zip(got, want, (jk[:, :out, :lanes], jv[:, :out, :lanes], jn[:lanes])):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)
    if case == "overflow" and out_of == "C/2":
        assert got[2].max() > out
    if case == "padding":
        assert not got[2][[x for x in (0, 5, 8, 16) if x < lanes]].any()


@pytest.mark.parametrize("threads", [128, 256, 512, 1024])
def test_rehearsed_walk_at_the_kernels_thread_counts(threads):
    """The instances' thread counts: at C = 64 most threads of the wider
    ones hold no run, and a run's next row lies in the next thread's run."""
    ka, va, kb, vb = draw(6, 64, "ties", seed=3)
    for out in (32, 128):
        got = rehearse(ka, va, kb, vb, out, threads)
        for g, w in zip(got, twin(ka, va, kb, vb, out)):
            np.testing.assert_array_equal(g, w)
