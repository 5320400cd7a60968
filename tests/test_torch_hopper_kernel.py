"""The hand-written CUDA lexn_union kernel against its plain PyTorch twin,
bit for bit.  Needs a card (marked ``cuda``; skips without one) and imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_hopper_kernel.py
"""
import numpy as np
import pytest
import torch

from crdt_tpu_torch.ops import hopper_union as hu

S = 2**31 - 1


def _planes(rng, c, lanes, g, fraction):
    """(hi, lo, val, pay): each lane a seeded subset of a g-op pool, sorted
    per lane by (hi, lo), the first c rows kept, SENTINEL/0 padded."""
    ids = np.sort(rng.choice(10 * g, g, replace=False))
    pool = [(ids // 4).astype(np.int32), ids.astype(np.int32),
            rng.integers(-20, 20, g).astype(np.int32),
            (rng.integers(0, 1000, g) | (rng.integers(0, 2, g) << 31)).astype(np.int32)]
    planes = [np.full((c, lanes), S, np.int32), np.full((c, lanes), S, np.int32),
              np.zeros((c, lanes), np.int32), np.zeros((c, lanes), np.int32)]
    for j in range(lanes):
        rows = np.nonzero(rng.random(g) < fraction)[0][:c]
        for p in range(4):
            planes[p][: len(rows), j] = pool[p][rows]
    return planes


def _run(planes_a, planes_b, out_size, device):
    t = [torch.from_numpy(x).to(device) for x in planes_a + planes_b]
    keys, vals, nu = hu.sorted_union_columnar_fused_lexn(
        t[:2], t[2:4], t[4:6], t[6:], out_size=out_size)
    return [x.cpu() for x in (*keys, *vals, nu)]


@pytest.mark.cuda
@pytest.mark.parametrize("c, lanes, g, out", [
    (8, 1, 16, 8), (8, 127, 16, 8), (8, 130, 16, None),
    (64, 130, 192, 64), (1024, 300, 2048, 1024),
])
def test_cuda_kernel_matches_plain_twin(c, lanes, g, out):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lexn_union kernel has no CPU mode")
    rng = np.random.default_rng(c + lanes)
    a, b = _planes(rng, c, lanes, g, 0.5), _planes(rng, c, lanes, g, 0.5)
    before = hu.LAUNCHES["lexn_union"]
    got = _run(a, b, out, "cuda")
    torch.cuda.synchronize()
    assert hu.LAUNCHES["lexn_union"] == before + 1
    want = _run(a, b, out, "cpu")
    for w, k in zip(want, got):
        assert torch.equal(w, k)


@pytest.mark.cuda
def test_cuda_kernel_refuses_capacity_past_shared_memory():
    """C=8192 at (2, 2) needs ~400 KB of shared memory per block, past the
    card's opt-in limit: the launch is refused and the wrapper raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lexn_union kernel has no CPU mode")
    planes = [torch.full((8192, 2), S, dtype=torch.int32, device="cuda")] * 4
    before = hu.LAUNCHES["lexn_union"]
    with pytest.raises(RuntimeError, match="shared memory"):
        hu.sorted_union_columnar_fused_lexn(planes[:2], planes[2:], planes[:2], planes[2:])
    assert hu.LAUNCHES["lexn_union"] == before


def _lex_side_planes(rng, n_keys, n_vals, c, lanes, universe, empty=(), inside=None):
    """Key and value planes of one operand: each lane a seeded subset of
    ``universe`` (rows of distinct n_keys-word keys, ascending), at most c
    rows, SENTINEL/0 padded; with ``inside`` (another side's per-lane row
    picks) each lane draws from that side's rows only.  Values are full
    int32 words (bit 31 included).  Returns (planes, picks)."""
    keys = np.full((n_keys, c, lanes), S, np.int32)
    vals = np.zeros((n_vals, c, lanes), np.int32)
    picks = []
    for j in range(lanes):
        pool = np.arange(len(universe)) if inside is None else inside[j]
        rows = np.sort(pool[rng.random(len(pool)) < 0.5])[:c]
        if j in empty:
            rows = rows[:0]
        picks.append(rows)
        keys[:, :len(rows), j] = universe[rows].T
        vals[:, :len(rows), j] = rng.integers(-2**31, 2**31, (n_vals, len(rows)))
    return [*keys, *vals], picks


def _lex_universe(rng, n_keys, size, full_range):
    """``size`` distinct keys in ascending lexicographic order: full-range
    int32 words (negatives, INT32_MIN, never SENTINEL in word 0), or word 0
    drawn from 4 values so that many keys tie on it and differ later."""
    if full_range:
        words = rng.integers(-2**31, 2**31 - 1, (2 * size, n_keys))
        words[: size // 8, 0] = -2**31
    else:
        words = rng.integers(0, 4, (2 * size, n_keys))
        words[:, -1] = rng.integers(-2**31, 2**31 - 1, 2 * size)
    u = np.unique(words, axis=0)
    return u[np.sort(rng.choice(len(u), min(size, len(u)), replace=False))].astype(np.int32)


def _offset_planes(planes):
    """The same planes on the card, each a contiguous view one int32 into
    its own buffer (off 16 B alignment)."""
    out = []
    for p in planes:
        buf = torch.empty(p.size + 1, dtype=torch.int32, device="cuda")
        buf[1:] = torch.from_numpy(np.ascontiguousarray(p)).flatten().cuda()
        out.append(buf[1:].view(p.shape))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys, n_vals, c, lanes, out, case", [
    (2, 2, 64, 1, 64, "full-range"),
    (2, 2, 64, 7, 32, "full-range"),
    (2, 2, 64, 9, None, "word-0 ties"),
    (2, 2, 64, 127, 64, "word-0 ties"),
    (2, 2, 64, 130, 32, "unaligned"),
    (2, 2, 64, 4097, 64, "word-0 ties"),
    (2, 2, 1024, 130, 1024, "unaligned"),
    (2, 2, 1024, 300, 512, "full-range"),
    (2, 2, 1024, 300, None, "inside, empty lanes"),
    (2, 2, 1024, 5, 1024, "word-0 ties"),
    (2, 2, 1024, 10, 1024, "word-0 ties"),
    (2, 2, 1024, 20, 1024, "full-range"),
    (1, 3, 256, 33, 256, "full-range"),
    (3, 1, 128, 17, None, "word-0 ties"),
    (18, 2, 512, 130, 512, "word-0 ties"),
])
def test_lexn_union_tile_edges_match_twin(n_keys, n_vals, c, lanes, out, case):
    """The tile body at lane counts that split a tile of 8 and at the
    converge tree's narrow levels, planes off 16 B alignment, all-padding
    lanes beside lanes whose B rows all lie in A, full-range int32 keys,
    keys tied on word 0, overflow and untruncated outputs — and (18, 2) at
    C=512, which takes the wide body, in the same process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lexn_union kernel has no CPU mode")
    rng = np.random.default_rng(c * 7 + lanes + n_keys)
    universe = _lex_universe(rng, n_keys, 2 * c, case == "full-range")
    empty = (0, 7, 8, lanes - 1) if case.startswith("inside") else ()
    a, picks = _lex_side_planes(rng, n_keys, n_vals, c, lanes, universe, empty)
    b, _ = _lex_side_planes(rng, n_keys, n_vals, c, lanes, universe, empty,
                            inside=picks if case.startswith("inside") else None)
    limit = hu.smem_limit(torch.device("cuda"))
    want_tile = n_keys <= hu.TILE_MAX_KEYS
    assert (hu.lexn_union_body(n_keys, n_vals, c, 2 * c if out is None else out,
                               limit)[1] > 0) == want_tile
    ta = _offset_planes(a) if case == "unaligned" else [torch.from_numpy(x).cuda() for x in a]
    tb = _offset_planes(b) if case == "unaligned" else [torch.from_numpy(x).cuda() for x in b]
    if case == "unaligned":
        assert ta[0].data_ptr() % 16 != 0
    before = hu.LAUNCHES["lexn_union"]
    keys, vals, nu = hu.sorted_union_columnar_fused_lexn(
        ta[:n_keys], ta[n_keys:], tb[:n_keys], tb[n_keys:], out_size=out)
    torch.cuda.synchronize()
    assert hu.LAUNCHES["lexn_union"] == before + 1
    ca = [torch.from_numpy(x) for x in a]
    cb = [torch.from_numpy(x) for x in b]
    wk, wv, wn = hu.sorted_union_columnar_fused_lexn(
        ca[:n_keys], ca[n_keys:], cb[:n_keys], cb[n_keys:], out_size=out)
    assert torch.equal(nu.cpu(), wn)
    assert torch.equal(keys.cpu(), wk)
    assert torch.equal(vals.cpu(), wv)
    if out is not None and out < c:
        assert int(wn.max()) > out  # the overflow case overflows
