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


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [hu.sorted_union_columnar_fused, hu.bitonic_merge_columnar])
def test_set_kernels_refuse_capacity_past_shared_memory(fn):
    """C=16,384 needs ~390 KB of shared memory at one lane a block, past
    the card's opt-in limit: the launch is refused and the wrapper raises
    with the figure."""
    _need_card()
    planes = [torch.full((16384, 2), S, dtype=torch.int32, device="cuda")] * 4
    before = dict(hu.LAUNCHES)
    with pytest.raises(RuntimeError, match="shared memory"):
        fn(*planes)
    assert hu.LAUNCHES == before
