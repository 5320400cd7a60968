"""The hand-written CUDA kernels of csrc/set_union.cu — the single-key
union (set_union), its merge stage (merge) and the bucket-local union
(bucketed_union) — against their plain PyTorch twins, bit for bit.  Needs
a card (marked ``cuda``; skips without one) and imports no JAX, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_set_kernels.py
"""
import numpy as np
import pytest
import torch

from crdt_tpu_torch.ops import hopper_union as hu

S = 2**31 - 1


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the set_union kernels have no CPU mode")


def _columns(rng, c, lanes, space, wb=None, flagged=False):
    """(keys, vals) int32[C, L]: per lane unique ascending keys with a
    SENTINEL tail (per bucket of ``wb`` rows when given), values random
    int32 bits on live rows and 0 on padding — or 1 on padding when
    ``flagged`` (a tombstoned tag that packs to SENTINEL is padding too)."""
    keys = np.full((c, lanes), S, np.int32)
    vals = np.zeros((c, lanes), np.int32)
    segs = [(0, c, space, 0)] if wb is None else [
        (b * wb, wb, space // (c // wb), b * (space // (c // wb))) for b in range(c // wb)]
    for j in range(lanes):
        for row0, rows, span, base in segs:
            n = int(rng.integers(0, rows + 1))
            ks = np.sort(rng.choice(span, n, replace=False)) + base
            keys[row0:row0 + n, j] = ks
            vals[row0:row0 + n, j] = rng.integers(-2**31, 2**31, n)
            if flagged:
                vals[row0 + n:row0 + rows, j] = 1
    return keys, vals


def _both(fn, planes, **kw):
    got = fn(*(torch.from_numpy(p).cuda() for p in planes), **kw)
    torch.cuda.synchronize()
    want = fn(*(torch.from_numpy(p) for p in planes), **kw)
    return [g.cpu() for g in got], list(want)


@pytest.mark.cuda
@pytest.mark.parametrize("c, lanes, out, flagged", [
    (8, 1, 8, False), (8, 127, None, False), (64, 130, 64, False), (64, 130, 20, False),
    (1024, 300, 1024, False), (1024, 300, 512, False), (64, 130, 64, True),
])
def test_set_union_and_merge_kernels_match_twins(c, lanes, out, flagged):
    _need_card()
    rng = np.random.default_rng(c + lanes + (out or 0))
    # a key space of 3C/2 makes a third of each side's keys duplicates
    planes = [*_columns(rng, c, lanes, 3 * c // 2, flagged=flagged),
              *_columns(rng, c, lanes, 3 * c // 2, flagged=flagged)]
    before = dict(hu.LAUNCHES)
    got, want = _both(hu.sorted_union_columnar_fused, planes, out_size=out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got, want = _both(hu.bitonic_merge_columnar, planes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got, want = _both(hu.sorted_union_columnar_unfused, planes, out_size=out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert hu.LAUNCHES["set_union"] == before["set_union"] + 1
    assert hu.LAUNCHES["merge"] == before["merge"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("c, n_buckets, out_r, lanes, flagged", [
    (64, 4, 16, 1, False), (64, 4, 32, 127, False), (64, 4, 5, 130, False),
    (1024, 64, 16, 300, False), (1024, 64, 32, 300, False), (256, 2, 128, 33, False),
    (64, 4, 16, 130, True), (48, 3, 16, 130, False),
])
def test_bucketed_union_kernel_matches_twin(c, n_buckets, out_r, lanes, flagged):
    _need_card()
    rng = np.random.default_rng(c + n_buckets + out_r + lanes)
    wb = c // n_buckets
    planes = [*_columns(rng, c, lanes, 1 << 15, wb, flagged),
              *_columns(rng, c, lanes, 1 << 15, wb, flagged)]
    before = hu.LAUNCHES["bucketed_union"]
    got, want = _both(hu.bucketed_union_columnar, planes, n_buckets=n_buckets,
                      out_bucket_rows=out_r)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert hu.LAUNCHES["bucketed_union"] == before + 1


def _bucketed_one(*planes):
    """Kernel 3 with one bucket, untruncated: the whole lane as its bucket."""
    return hu.bucketed_union_columnar(*planes, n_buckets=1, out_bucket_rows=2 * planes[0].shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("fn, c", [
    (hu.sorted_union_columnar_fused, 16_384),  # 262,212 B at one lane
    (hu.bitonic_merge_columnar, 32_768),       # past the keep-all body's 16,384 rows
    (_bucketed_one, 16_384),                   # 524,288 B at one lane and one buffer
], ids=["set_union", "merge", "bucketed_union"])
def test_set_kernels_refuse_capacity_past_shared_memory(fn, c):
    """The first shape past each body's envelope: the launch is refused and
    the wrapper raises with the plan's figure, counting no launch."""
    _need_card()
    planes = [torch.full((c, 2), S, dtype=torch.int32, device="cuda")] * 4
    before = dict(hu.LAUNCHES)
    with pytest.raises(RuntimeError, match="shared memory"):
        fn(*planes)
    assert hu.LAUNCHES == before


@pytest.mark.cuda
def test_merge_at_16384_rows_matches_twin():
    """C = 16,384 took the first template past the card's limit; the
    keep-all body's 16-bit map takes it at one lane (196,676 B): the merge
    now launches and equals its twin."""
    _need_card()
    rng = np.random.default_rng(16_384)
    planes = [*_columns(rng, 16_384, 3, 24_576), *_columns(rng, 16_384, 3, 24_576)]
    before = hu.LAUNCHES["merge"]
    got, want = _both(hu.bitonic_merge_columnar, planes)
    assert hu.LAUNCHES["merge"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _on_card(planes, unaligned=False):
    """numpy planes as CUDA tensors; ``unaligned`` puts each one word past
    a 16 B boundary."""
    if not unaligned:
        return [torch.from_numpy(p).cuda() for p in planes]
    tensors = []
    for p in planes:
        buf = torch.empty(p.size + 1, dtype=torch.int32, device="cuda")
        buf[1:] = torch.from_numpy(p).flatten().cuda()
        tensors.append(buf[1:].view(p.shape))
    assert tensors[0].data_ptr() % 16 != 0
    return tensors


def _full_range(rng, c, lanes, empty=(), inside=None):
    """(keys, vals) int32[C, L] over full-range int32 keys (negatives,
    INT32_MIN; never SENTINEL), each lane half of a 2C-key universe, or of
    ``inside``'s keys; values full int32 words (bit 31 included); lanes of
    ``empty`` all padding."""
    universe = np.unique(np.concatenate([
        [-2**31], rng.integers(-2**31, 2**31 - 1, 4 * c)]))[: 2 * c]
    keys = np.full((c, lanes), S, np.int32)
    vals = np.zeros((c, lanes), np.int32)
    for j in range(lanes):
        pool = universe if inside is None else inside[:, j][inside[:, j] != S]
        ks = np.sort(pool[rng.random(len(pool)) < 0.5])[:c]
        if j in empty:
            ks = ks[:0]
        keys[: len(ks), j] = ks
        vals[: len(ks), j] = rng.integers(-2**31, 2**31, len(ks))
    return keys, vals


@pytest.mark.cuda
@pytest.mark.parametrize("c, lanes, out, case", [
    (64, 1, 64, "uniform"), (64, 7, 32, "uniform"), (64, 9, None, "full-range"),
    (64, 127, 64, "full-range"), (64, 130, 64, "unaligned"), (64, 4097, 32, "uniform"),
    (1024, 1, 1024, "full-range"), (1024, 9, 512, "uniform"),
    (1024, 130, 1024, "unaligned"), (1024, 4097, None, "full-range"),
    (1024, 300, 1024, "inside, empty lanes"), (2048, 33, 2048, "uniform"),
])
def test_set_union_tile_edges_match_twin(c, lanes, out, case):
    """Kernel 2's tile body at lane counts that split a tile of 8, planes
    off 16 B alignment, all-padding lanes beside lanes whose B keys all lie
    in A, full-range int32 keys and values, overflow (out = C/2) and
    untruncated outputs: every output bit-equal to the twin."""
    _need_card()
    rng = np.random.default_rng(c + lanes + (out or 0))
    if case == "uniform":
        planes = [*_columns(rng, c, lanes, 3 * c // 2), *_columns(rng, c, lanes, 3 * c // 2)]
    else:
        empty = (0, 7, 8, lanes - 1) if case.startswith("inside") else ()
        ka, va = _full_range(rng, c, lanes, empty)
        kb, vb = _full_range(rng, c, lanes, empty, ka if case.startswith("inside") else None)
        planes = [ka, va, kb, vb]
    tensors = _on_card(planes, case == "unaligned")
    before = hu.LAUNCHES["set_union"]
    got = hu.sorted_union_columnar_fused(*tensors, out_size=out)
    torch.cuda.synchronize()
    assert hu.LAUNCHES["set_union"] == before + 1
    want = hu.sorted_union_columnar_fused(*(torch.from_numpy(p) for p in planes), out_size=out)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if out is not None and out < c:
        assert int(want[2].max()) > out  # the overflow case overflows


def _edge_planes(rng, c, lanes, case, wb=None):
    """Both operands of an edge case, as numpy planes: ``uniform`` (a key
    space of 3C/2, so a third of the keys are duplicates; per bucket when
    ``wb`` is given), ``flagged`` (the same with A's padding values 1 and
    B's 2), ``full-range`` and ``unaligned`` (full-range int32 keys and
    values, each bucket drawn on its own), ``inside, empty lanes`` (B's keys
    all in A, lanes 0, 7, 8 and the last all padding)."""
    wb = wb or c
    if case in ("uniform", "flagged"):
        ka, va = _columns(rng, c, lanes, 3 * c // 2, wb, case == "flagged")
        kb, vb = _columns(rng, c, lanes, 3 * c // 2, wb, case == "flagged")
        vb[(kb == S) & (vb == 1)] = 2
        return [ka, va, kb, vb]
    inside = case.startswith("inside")
    empty = (0, 7, 8, lanes - 1) if inside else ()
    parts = []
    for r0 in range(0, c, wb):
        ka, va = _full_range(rng, wb, lanes, empty)
        kb, vb = _full_range(rng, wb, lanes, empty, ka if inside else None)
        parts.append((ka, va, kb, vb))
    return [np.concatenate([p[i] for p in parts]) for i in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("c, n_buckets, out_r, lanes, case", [
    (1024, 64, 16, 1, "uniform"), (1024, 64, 32, 7, "full-range"),
    (1024, 64, 0, 9, "uniform"), (1024, 64, 5, 127, "full-range"),
    (1024, 64, 16, 130, "unaligned"), (1024, 64, 32, 4097, "uniform"),
    (1024, 64, 17, 4097, "flagged"), (1024, 64, 16, 300, "inside, empty lanes"),
    (1024, 64, 32, 130, "flagged"), (48, 3, 16, 130, "full-range"), (48, 3, 7, 9, "unaligned"),
    (64, 64, 1, 130, "uniform"), (64, 64, 2, 33, "full-range"),      # Wb = 1
    (512, 2, 256, 130, "uniform"), (512, 2, 512, 9, "full-range"),  # Wb = 256
    (256, 1, 512, 9, "flagged"), (4096, 16, 512, 33, "uniform"),    # 16 lanes a CTA
])
def test_bucketed_union_segment_edges_match_twin(c, n_buckets, out_r, lanes, case):
    """Kernel 3's segment body at lane counts that split a CTA's lanes or a
    16 B chunk, planes off 16 B alignment, full-range int32 keys and values,
    all-padding lanes beside lanes whose B keys all lie in A, flagged
    padding, out_r = 0, Wb, 2 Wb and odd, C = 48 with 3 buckets, Wb = 1,
    16 and 256, and plans of fewer than 32 lanes a CTA: every output
    bit-equal to the twin."""
    _need_card()
    rng = np.random.default_rng(c + n_buckets + out_r + lanes)
    wb = c // n_buckets
    planes = _edge_planes(rng, c, lanes, case, wb)
    before = hu.LAUNCHES["bucketed_union"]
    got = hu.bucketed_union_columnar(*_on_card(planes, case == "unaligned"),
                                     n_buckets=n_buckets, out_bucket_rows=out_r)
    torch.cuda.synchronize()
    assert hu.LAUNCHES["bucketed_union"] == before + 1
    want = hu.bucketed_union_columnar(*(torch.from_numpy(p) for p in planes),
                                      n_buckets=n_buckets, out_bucket_rows=out_r)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if wb >= 16 and out_r < wb // 2 and case != "inside, empty lanes":
        assert int(want[3].max()) > out_r  # a truncating case truncates


@pytest.mark.cuda
@pytest.mark.parametrize("c, lanes, case", [
    (8, 1, "uniform"), (8, 7, "flagged"), (8, 9, "full-range"), (8, 4097, "unaligned"),
    (1024, 127, "uniform"), (1024, 130, "unaligned"), (1024, 4097, "full-range"),
    (1024, 300, "inside, empty lanes"), (1024, 130, "flagged"),
    (4096, 9, "uniform"), (4096, 130, "full-range"), (4096, 33, "flagged"),
])
def test_merge_keep_all_edges_match_twin(c, lanes, case):
    """Kernel 6 on the lane tile's keep-all mode at C = 8, 1024 and 4096:
    lane counts that split a tile of 8, planes off 16 B alignment,
    full-range keys, all-padding lanes beside B inside A, and padding whose
    values differ by side (A's tail first): bit-equal to the twin."""
    _need_card()
    rng = np.random.default_rng(c + lanes)
    planes = _edge_planes(rng, c, lanes, case)
    before = hu.LAUNCHES["merge"]
    got = hu.bitonic_merge_columnar(*_on_card(planes, case == "unaligned"))
    torch.cuda.synchronize()
    assert hu.LAUNCHES["merge"] == before + 1
    want = hu.bitonic_merge_columnar(*(torch.from_numpy(p) for p in planes))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
