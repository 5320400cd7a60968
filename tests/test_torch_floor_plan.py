"""The OR-Set floors' Hopper bodies (csrc/set_floor.cu) as far as they run
without a card: the host plans and their shared-memory figures at the
H100's 232,448 B a block, pinned against a part-by-part count; the
envelope (every capacity the first template launched, and a refusal past
it); the two facts the kernels rest on (a butterfly network's row 0 is its
segment's total; the value output needs only the values' low half); and
numpy rehearsals of both bodies — the tile body's thread layouts,
shuffles, edge exchange and segmented scan, and the segment walk's punch
across bucket edges — against the plain twin, bit for bit.  The kernels
themselves are held against the twin on the card by
test_torch_orset_floor_cuda.py."""
import numpy as np
import pytest
import torch

from crdt_tpu_torch.ops import hopper_union as hu
from crdt_tpu_torch.ops import orset_floor as of

LIMIT = hu.HOPPER_SMEM_OPTIN
S = np.uint32(2**31 - 1)
THREADS = 512


def tile_layout_bytes(c, lanes, rows):
    """The tile body's shared memory counted part by part: three plane
    buffers of ``lanes`` lanes x 2C rows, and four arrays of a word a
    thread (each chunk's first and last row, the warp groups' sums and
    odd counts)."""
    return 3 * lanes * 2 * c * 4 + 4 * THREADS * 4


def walk_layout_bytes(wb, width, stages):
    """The walk's shared memory: ``stages`` buffers of one bucket of the
    four input planes."""
    return stages * 4 * wb * width * 4


def first_template_bytes(c):
    """The first floor template's shared memory at one lane a CTA: two
    columns of 2C words padded a word every max(2C/32, 32) rows, rounded to
    32, plus 32."""
    n = 2 * c
    ps = max(n.bit_length() - 1 - 5, 5)
    return 4 * 2 * (((n + (n >> ps) + 31) & ~31) + 32)


@pytest.mark.parametrize("c, plan", [
    (1024, (8, 32, 204_800)),   # the OR-Set floor: 8 lanes a tile, whole 32 B rows
    (2048, (4, 32, 204_800)),
    (8192, (1, 32, 204_800)),   # the envelope's top: one lane a tile
    (64, (128, 32, 204_800)),
    (16, (512, 32, 204_800)),   # 2C = R: one thread a lane
    (8, (512, 16, 106_496)),
    (1, (512, 2, 20_480)),
])
def test_floor_tile_plan_at_the_h100_limit(c, plan):
    assert of.floor_tile_plan(c) == plan
    lanes, rows, smem = plan
    assert smem == tile_layout_bytes(c, lanes, rows) <= LIMIT
    assert lanes * 2 * c == THREADS * rows


@pytest.mark.parametrize("c, n_buckets, plan", [
    (1024, 64, ("walk", 256, 3, 196_608)),   # the dispatcher's B = C/16: Wb = 16
    (1024, 128, ("walk", 256, 4, 131_072)),
    (1024, 1024, ("walk", 256, 4, 16_384)),  # Wb = 1
    (16, 1, ("walk", 256, 1, 65_536)),       # one bucket: one buffer
    (64, 4, ("walk", 256, 3, 196_608)),
    (1024, 2, ("tile", 8, 32, 204_800)),     # Wb = 512: the tile body
    (32, 1, ("tile", 256, 32, 204_800)),     # Wb = 32
    (8192, 1, ("tile", 1, 32, 204_800)),
])
def test_bucketed_floor_plan_at_the_h100_limit(c, n_buckets, plan):
    assert of.bucketed_floor_plan(c, n_buckets, LIMIT) == plan
    if plan[0] == "walk":
        _, width, stages, smem = plan
        assert smem == walk_layout_bytes(c // n_buckets, width, stages) <= LIMIT
        assert min(2, n_buckets) <= stages <= min(n_buckets, hu.SEGMENT_MAX_STAGES)
    else:
        assert plan[1:] == of.floor_tile_plan(c)


@pytest.mark.parametrize("c", [1 << k for k in range(14)])
def test_the_floors_launch_wherever_the_first_template_did(c):
    """C = 1 .. 8,192: the first template launched (one lane a CTA fits the
    card), and so does every plan of the new bodies, at every bucket count;
    the tile body covers the lane's rows with its 512 threads exactly."""
    assert first_template_bytes(c) <= LIMIT
    lanes, rows, smem = of.floor_tile_plan(c)
    assert smem <= LIMIT and lanes * 2 * c == THREADS * rows
    n_buckets = 1
    while n_buckets <= c:
        assert of.bucketed_floor_plan(c, n_buckets, LIMIT)[-1] <= LIMIT
        n_buckets *= 2


def test_the_floors_refuse_past_the_envelope():
    """C = 16,384: the first template's column did not fit, and the tile
    body's plan is one lane whose ring holds three whole columns — a figure
    past the limit, which the refused launch reports."""
    c = 16_384
    assert first_template_bytes(c) > LIMIT
    lanes, rows, smem = of.floor_tile_plan(c)
    assert (lanes, rows) == (1, 32) and lanes * 2 * c != THREADS * rows
    assert smem == 4 * (3 * 2 * c + 4 * THREADS) == 401_408 > LIMIT
    assert of.bucketed_floor_plan(c, 1, LIMIT) == ("tile", 1, 32, 401_408)
    assert of.bucketed_floor_plan(c, c // 16, LIMIT)[0] == "walk"


# ---- the facts ----


def butterflies(keys, vals, seg):
    """The twin's butterflies on (2·seg, L) uint32 columns, widest first."""
    n, lanes = keys.shape
    stride = seg
    while stride >= 1:
        rk = keys.reshape(n // (2 * stride), 2, stride, lanes)
        rv = vals.reshape(n // (2 * stride), 2, stride, lanes)
        keys = np.stack([rk[:, 0] + rk[:, 1], rk[:, 0] - rk[:, 1]], axis=1).reshape(n, lanes)
        vals = np.stack([rv[:, 0] | rv[:, 1], rv[:, 0] ^ rv[:, 1]], axis=1).reshape(n, lanes)
        stride //= 2
    return keys, vals


@pytest.mark.parametrize("seg", [1, 2, 16, 512])
def test_butterfly_row_0_is_the_wrapped_sum_and_the_or(seg):
    rng = np.random.default_rng(seg)
    keys = rng.integers(-2**31, 2**31, (2 * seg, 64)).astype(np.int32).view(np.uint32)
    vals = rng.integers(-2**31, 2**31, (2 * seg, 64)).astype(np.int32).view(np.uint32)
    bk, bv = butterflies(keys, vals, seg)
    np.testing.assert_array_equal(bk[0], keys.sum(axis=0, dtype=np.uint32))
    np.testing.assert_array_equal(bv[0], np.bitwise_or.reduce(vals, axis=0))


def test_value_output_is_the_low_half_of_the_suffix_or():
    """disp = p | v << 16 with p < 2^16: disp's suffix OR, shifted right
    arithmetically, is the values' suffix OR's low half sign-extended."""
    rng = np.random.default_rng(1)
    v = rng.integers(-2**31, 2**31, (64, 32)).astype(np.int32)
    p = rng.integers(0, 1 << 15, (64, 32)).astype(np.int32)
    disp = p | (v << 16)
    suffix = lambda x: np.bitwise_or.accumulate(x[::-1], axis=0)[::-1]  # noqa: E731
    want = suffix(disp) >> 16
    low = suffix(v).astype(np.uint32) << np.uint32(16)
    np.testing.assert_array_equal(want, low.view(np.int32) >> 16)


# ---- rehearsals of the two bodies ----


def planes(c, lanes, seed):
    """Full-range int32 keys with a fifth SENTINEL, values past 2^15."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        keys = rng.integers(-2**31, 2**31, (c, lanes)).astype(np.int32)
        keys[rng.random((c, lanes)) < 0.2] = 2**31 - 1
        out += [keys, rng.integers(-2**31, 2**31, (c, lanes)).astype(np.int32)]
    return out


def twin(ps, seg, out_seg):
    c = ps[0].shape[0]
    t = [torch.from_numpy(p) for p in ps]
    got = of._floor_plain(t[0], t[1], of._flip_buckets(t[2], c // seg),
                          of._flip_buckets(t[3], c // seg), seg, out_seg)
    return [g.numpy() for g in got]


def value_out(v_or):
    return (v_or << np.uint32(16)).view(np.int32) >> 16


def reg_stages(x, keys, unit, hi):
    """set_floor.cu reg_stages on x (threads, R): register distances R/2 ..
    1 (row strides unit·R/2 .. unit), widest first, strides <= hi."""
    r = x.shape[1]
    k = r.bit_length() - 2
    while k >= 0:
        h = 1 << k
        if unit * h <= hi:
            v = x.reshape(x.shape[0], r // (2 * h), 2, h)
            a, b = v[:, :, 0].copy(), v[:, :, 1].copy()
            v[:, :, 0], v[:, :, 1] = (a + b, a - b) if keys else (a | b, a ^ b)
        k -= 1


def shfl(x, src, t):
    """__shfl_*_sync: thread t reads thread src's x, or its own where src
    lies outside its warp."""
    ok = (src >= 0) & (src < THREADS) & (src // 32 == t // 32)
    return np.where(ok.reshape((-1,) + (1,) * (x.ndim - 1)), x[np.clip(src, 0, THREADS - 1)], x)


def emulate_tile(ps, seg, out_seg):
    """floor_tile_kernel, thread by thread in numpy: one (threads, R)
    register file a plane of a tile, the plane buffer a flat array of words
    addressed as the kernel addresses it (the loads place merged row m of
    lane l at swz(m)·LT + l; the two compute layouts read it through their
    base pointers, immediate offsets and XORs)."""
    ka, va, kb, vb = (p.view(np.uint32) for p in ps)
    c, lanes = ka.shape
    n = 2 * c
    lt, r_, _ = of.floor_tile_plan(c)
    assert 2 * seg >= r_, "the launcher refuses a segment shorter than a chunk"
    tpl = THREADS // lt
    lt_shift = lt.bit_length() - 1
    mask = 0 if lt >= 32 else 32 // lt - 1
    wq = 1 if lt >= 32 else 32 // lt
    g = 2 * seg // r_
    seg2 = 2 * seg
    t = np.arange(THREADS)
    l, q = t % lt, t // lt
    j = np.arange(r_)

    def swz(m):
        return m ^ ((m >> 5) & mask)

    nb = c // seg
    rows = np.arange(c)
    merged_a = (rows // seg) * seg2 + rows % seg
    merged_b = (rows // seg) * seg2 + seg2 - 1 - rows % seg
    ko = np.zeros((nb * out_seg, lanes), np.uint32)
    vo = np.zeros((nb * out_seg, lanes), np.int32)
    nu = np.zeros((1, lanes), np.int32)
    # layout 1: two base words, then 512·(j & ~1) words further
    c0, c1 = swz(q) * lt + l, swz(q + tpl) * lt + l
    addr1 = np.where((j & 1)[None, :], c1[:, None], c0[:, None]) + THREADS * (j & ~1)[None, :]
    # layout 2: the base ^ (j << lt_shift)
    base2 = (r_ * q + (q & mask)) * lt + l
    addr2 = base2[:, None] ^ (j[None, :] << lt_shift)
    for tile in range(-(-lanes // lt)):
        cols = tile * lt + np.arange(lt)
        live = cols < lanes
        for keys, (pa, pb) in ((True, (ka, kb)), (False, (va, vb))):
            buf = np.zeros(n * lt, np.uint32)
            for merged, src in ((merged_a, pa), (merged_b, pb)):
                at = swz(merged)[:, None] * lt + np.arange(lt)[None, live]
                buf[at] = src[:, cols[live]]
            x = buf[addr1]
            reg_stages(x, keys, tpl, seg)
            buf[addr1] = x
            x = buf[addr2]
            st = tpl // 2
            while st >= r_:
                if st <= seg:
                    d = st // r_
                    y = shfl(x, t ^ (d * lt), t)
                    up = ((q & d) != 0)[:, None]
                    x = np.where(up, y - x, x + y) if keys else np.where(up, x ^ y, x | y)
                st //= 2
            reg_stages(x, keys, 1, min(seg, tpl // 2))
            has_next = q + 1 < tpl
            after = np.where(has_next, x[np.minimum(t + lt, THREADS - 1), 0], np.uint32(0))
            if keys:
                before = np.where(q > 0, x[np.maximum(t - lt, 0), r_ - 1], S)
                k1_after = np.where(has_next, after + x[:, r_ - 1], np.uint32(0))
                k1 = x + np.concatenate([before[:, None], x[:, :-1]], axis=1)
                x = k1 ^ np.concatenate([k1[:, 1:], k1_after[:, None]], axis=1)
                a = x.sum(axis=1, dtype=np.uint32)
                b = (x & 1).sum(axis=1, dtype=np.uint32)
            else:
                x = x | np.concatenate([x[:, 1:], after[:, None]], axis=1)
                a = np.bitwise_or.reduce(x, axis=1)
                b = np.zeros_like(a)
            carry = np.zeros(THREADS, np.uint32)
            carry_odd = np.zeros(THREADS, np.uint32)
            if g > 1:
                gw = min(g, wq)
                d = 1
                while d < gw:
                    ya, yb = shfl(a, t + d * lt, t), shfl(b, t + d * lt, t)
                    cond = (q & (gw - 1)) + d < gw
                    a = np.where(cond, a + ya if keys else a | ya, a)
                    b = np.where(cond, b + yb, b)
                    d *= 2
                if gw > 1:
                    end = (q & (gw - 1)) == gw - 1
                    carry = np.where(end, np.uint32(0), shfl(a, t + lt, t))
                    carry_odd = np.where(end, np.uint32(0), shfl(b, t + lt, t))
                if g > wq:
                    grp = q // wq
                    gsum = np.zeros(THREADS, np.uint32)
                    gcnt = np.zeros(THREADS, np.uint32)
                    lead = q % wq == 0
                    gsum[(grp * lt + l)[lead]] = a[lead]
                    gcnt[(grp * lt + l)[lead]] = b[lead]
                    end_grp = grp | (g // wq - 1)
                    for k in range(1, THREADS):
                        more = grp + k <= end_grp
                        if not more.any():
                            break
                        at = np.where(more, (grp + k) * lt + l, 0)
                        add = np.where(more, gsum[at], 0).astype(np.uint32)
                        carry = carry + add if keys else carry | add
                        carry_odd = carry_odd + np.where(more, gcnt[at], 0).astype(np.uint32)
            acc, odd = carry, carry_odd
            lane = tile * lt + l
            live_t = lane < lanes
            i0 = r_ * q
            r0 = i0 & (seg2 - 1)
            keep = out_seg - r0
            o0 = (i0 // seg2) * out_seg + r0
            for jj in range(r_ - 1, -1, -1):
                if keys:
                    acc = acc + x[:, jj]
                    odd = odd + (x[:, jj] & 1)
                else:
                    acc = acc | x[:, jj]
                put = live_t & (jj < keep)
                if keys:
                    ko[(o0 + jj)[put], lane[put]] = acc[put]
                else:
                    vo[(o0 + jj)[put], lane[put]] = value_out(acc[put])
            if keys:
                at_nu = live_t & (i0 == n - seg2)
                nu[0, lane[at_nu]] = odd[at_nu].view(np.int32)
    return [ko.view(np.int32), vo, nu]


def emulate_walk(ps, n_buckets):
    """floor_walk_kernel, every lane at once in numpy: bucket b's rows are
    butterflied, then bucket b - 1 is finished with this segment's row 0."""
    ka, va, kb, vb = (p.view(np.uint32) for p in ps)
    c, lanes = ka.shape
    wb = c // n_buckets
    ko = np.zeros((c, lanes), np.uint32)
    vo = np.zeros((c, lanes), np.int32)
    k_last = np.full(lanes, S)
    k1_last = v_last = odd = np.zeros(lanes, np.uint32)
    ks = vs = None

    def finish(bb, k1_next, v_next):
        k3_last = k1_last ^ k1_next
        ko[bb * wb:(bb + 1) * wb] = ks + k3_last
        vo[bb * wb:(bb + 1) * wb] = value_out(vs | (v_last | v_next))
        return k3_last

    for b in range(n_buckets):
        rows = slice(b * wb, (b + 1) * wb)
        x, y = butterflies(np.concatenate([ka[rows], kb[rows][::-1]]),
                           np.concatenate([va[rows], vb[rows][::-1]]), wb)
        if b > 0:
            finish(b - 1, x[0] + k_last, y[0])
        k1 = x + np.concatenate([k_last[None], x[:-1]])
        k_last, v_last, k1_last = x[-1], y[-1], k1[-1]
        k3 = k1[:-1] ^ k1[1:]
        v2 = y[:-1] | y[1:]
        ks = np.cumsum(k3[::-1], axis=0, dtype=np.uint32)[::-1][:wb]
        vs = np.bitwise_or.accumulate(v2[::-1], axis=0)[::-1][:wb]
        odd = (k3 & 1).sum(axis=0, dtype=np.uint32)
    k3_last = finish(n_buckets - 1, np.uint32(0), np.uint32(0))
    nu = (odd + (k3_last & 1)).view(np.int32)[None]
    return [ko.view(np.int32), vo, nu]


@pytest.mark.parametrize("c", [8, 16, 32, 64])
@pytest.mark.parametrize("which", ["1", "2", "C"])
def test_walk_rehearsal_matches_the_twin(c, which):
    """The walk's punch across bucket edges (the carried last key, the next
    segment's row 0 as its butterflied total) == the twin, B = 1, 2, C."""
    n_buckets = {"1": 1, "2": 2, "C": c}[which]
    ps = planes(c, 37, seed=c + n_buckets)
    wb = c // n_buckets
    for got, want in zip(emulate_walk(ps, n_buckets), twin(ps, wb, wb)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c, seg, out_seg, lanes", [
    (1024, 1024, 1024, 9),   # the OR-Set floor's shape: the shuffle stage, scans across warps
    (1024, 1024, 0, 3),
    (1024, 1024, 2048, 3),
    (1024, 512, 512, 3),     # the bucketed floor at B = 2 on the tile body
    (1024, 32, 32, 3),       # segments of one chunk
    (2048, 2048, 1024, 5),   # two shuffle stages, 4 lanes a tile
    (256, 256, 255, 70),     # 64 lanes a tile: one chunk of a lane a warp
    (64, 64, 64, 130),
    (64, 16, 16, 130),       # a segment of one chunk
    (8, 8, 8, 600),          # one thread a lane
    (1, 1, 2, 513),
])
def test_tile_rehearsal_matches_the_twin(c, seg, out_seg, lanes):
    ps = planes(c, lanes, seed=c + seg + out_seg + lanes)
    for got, want in zip(emulate_tile(ps, seg, out_seg), twin(ps, seg, out_seg)):
        np.testing.assert_array_equal(got, want)


def test_tile_rehearsal_at_the_envelope_top():
    """C = 8,192, one lane a tile: four shuffle stages, sixteen warp groups."""
    ps = planes(8192, 1, seed=3)
    for got, want in zip(emulate_tile(ps, 8192, 8192), twin(ps, 8192, 8192)):
        np.testing.assert_array_equal(got, want)
