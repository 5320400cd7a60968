"""The lexN merge (kernel #4), compaction (kernel #5) and the striped and
auto union paths of the port (crdt_tpu_torch.ops.hopper_union: the plain
twins the CPU runs) against the JAX package's Pallas kernels in interpret
mode, bit for bit; and the port's shared-memory envelope at the H100's
232,448 B.  The CUDA kernels against the twins are in
test_torch_rseq_cuda.py, which runs without JAX on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.ops import pallas_union as pu
from crdt_tpu_torch.ops import hopper_union as hu

S = 2**31 - 1
L = 128          # the Pallas kernels take lanes in tiles of 128
LIMIT = hu.HOPPER_SMEM_OPTIN


def lexn_operands(seed, nk, c, lanes=L, fill=None, agree=True):
    """(keys, vals) of one operand: per lane a seeded set of unique rows
    over a small alphabet (so the two operands share many keys), sorted
    lexicographically, SENTINEL/0 padded.  Value plane 0 is a function of
    the key; plane 1 is too when ``agree``, else a random 0/1 flag."""
    rng = np.random.default_rng(seed)
    keys = np.full((nk, c, lanes), S, np.int32)
    vals = np.zeros((2, c, lanes), np.int32)
    for j in range(lanes):
        n = c if fill is None else int(rng.integers(0, fill + 1))
        rows = np.unique(rng.integers(0, 4, (3 * c, nk)), axis=0)
        rows = rows[np.sort(rng.choice(len(rows), min(n, len(rows)), replace=False))]
        keys[:, :len(rows), j] = rows.T
        vals[0, :len(rows), j] = (rows * np.arange(1, nk + 1)).sum(1) + 7
        vals[1, :len(rows), j] = (rows[:, -1] & 1 if agree
                                  else rng.integers(0, 2, len(rows)))
    return list(keys), list(vals)


def jx(planes):
    return tuple(jnp.asarray(p) for p in planes)


def tc(planes):
    return tuple(torch.from_numpy(np.array(p)) for p in planes)


def assert_planes(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_merge_twin_matches_pallas_merge_where_copies_agree():
    ka, va = lexn_operands(1, 3, 32, fill=32)
    kb, vb = lexn_operands(2, 3, 32, fill=32)
    wk, wv = pu.lexn_merge_columnar(jx(ka), jx(va), jx(kb), jx(vb), interpret=True)
    gk, gv = hu.lexn_merge_columnar(tc(ka), tc(va), tc(kb), tc(vb))
    assert_planes(wk, gk)
    assert_planes(wv, gv)


def test_merge_order_of_equal_keys_differs_from_pallas_until_compacted():
    """The order pin: where the two copies of a key carry different flags,
    the TPU's bitonic network puts either copy first, the port's rank merge
    always A's.  Keys agree, a raw value plane differs, and after the
    compaction's OR the two agree bit for bit with the JAX compaction."""
    ka, va = lexn_operands(3, 3, 32, agree=False)
    kb, vb = lexn_operands(4, 3, 32, agree=False)
    wk, wv = pu.lexn_merge_columnar(jx(ka), jx(va), jx(kb), jx(vb), interpret=True)
    gk, gv = hu.lexn_merge_columnar(tc(ka), tc(va), tc(kb), tc(vb))
    assert_planes(wk, gk)
    assert not np.array_equal(np.asarray(wv[1]), gv[1].numpy())
    wk, wv, wnu = pu.lexn_compact_columnar(wk, wv, 32, interpret=True)
    gk, gv, gnu = hu.lexn_compact_columnar(gk, gv, 32)
    assert_planes((*wk, *wv, wnu), (*gk, *gv, gnu))


@pytest.mark.parametrize("out_size", [32, 64, 16], ids=["out=C", "out=2C", "overflow"])
def test_compact_twin_matches_pallas_compact(out_size):
    ka, va = lexn_operands(5, 4, 32, fill=32, agree=False)
    kb, vb = lexn_operands(6, 4, 32, fill=32, agree=False)
    mk, mv = hu.lexn_merge_columnar(tc(ka), tc(va), tc(kb), tc(vb))
    wk, wv, wnu = pu.lexn_compact_columnar(jx(mk), jx(mv), out_size, interpret=True)
    gk, gv, gnu = hu.lexn_compact_columnar(mk, mv, out_size)
    assert_planes((*wk, *wv, wnu), (*gk, *gv, gnu))
    if out_size == 16:
        assert int(gnu.max()) > 16


@pytest.fixture(scope="module")
def striped_case():
    """C = 64, 4 key words, 2 value planes; the JAX fused union at 2C."""
    ka, va = lexn_operands(7, 4, 64, fill=64, agree=False)
    kb, vb = lexn_operands(8, 4, 64, fill=64, agree=False)
    want = pu.sorted_union_columnar_fused_lexn(jx(ka), jx(va), jx(kb), jx(vb),
                                               out_size=None, interpret=True)
    return (ka, va, kb, vb), want


@pytest.mark.parametrize("stripe, out_size", [
    (8, 64), (8, 128), (32, 64), (32, 128), (64, 64),
])
def test_striped_union_matches_pallas_fused(striped_case, stripe, out_size):
    """The block-bitonic network over 2M stripes (M = 8, 2, 1), the merge
    twin as merge-split, then the compaction twin, equals the JAX fused
    union (the out = C rows are the head of the out = 2C union)."""
    (ka, va, kb, vb), (wk, wv, wnu) = striped_case
    before = dict(hu.LAUNCHES)
    gk, gv, gnu = hu.sorted_union_columnar_striped_lexn(
        tc(ka), tc(va), tc(kb), tc(vb), out_size=out_size, stripe=stripe)
    assert_planes([np.asarray(p)[:out_size] for p in (*wk, *wv)], (*gk, *gv))
    np.testing.assert_array_equal(np.asarray(wnu), gnu.numpy())
    assert int(gnu.max()) > 64  # the case overflows C
    assert hu.LAUNCHES == before  # CPU tensors launch nothing


def test_auto_union_on_cpu_takes_the_fused_twin(striped_case, monkeypatch):
    """A CPU tensor always takes the fused union's twin (the JAX package's
    interpret rule), whatever the card's envelope would choose."""
    (ka, va, kb, vb), (wk, wv, wnu) = striped_case

    def striped_called(*_a, **_k):
        raise AssertionError("the striped path was taken for a CPU tensor")

    monkeypatch.setattr(hu, "sorted_union_columnar_striped_lexn", striped_called)
    gk, gv, gnu = hu.sorted_union_columnar_lexn_auto(tc(ka), tc(va), tc(kb), tc(vb),
                                                     out_size=64)
    assert_planes([np.asarray(p)[:64] for p in (*wk, *wv)], (*gk, *gv))
    np.testing.assert_array_equal(np.asarray(wnu), gnu.numpy())


def test_striped_rejects_a_bad_stripe_and_out_size():
    ka, va = lexn_operands(9, 2, 16, lanes=2)
    with pytest.raises(ValueError, match="stripe 3"):
        hu.sorted_union_columnar_striped_lexn(tc(ka), tc(va), tc(ka), tc(va), stripe=3)
    with pytest.raises(ValueError, match="stripe 32"):
        hu.sorted_union_columnar_striped_lexn(tc(ka), tc(va), tc(ka), tc(va), stripe=32)
    with pytest.raises(ValueError, match="out_size"):
        hu.sorted_union_columnar_striped_lexn(tc(ka), tc(va), tc(ka), tc(va), out_size=33)
    with pytest.raises(ValueError, match="out_size"):
        hu.lexn_compact_columnar(tc(ka), tc(va), 17)


# ---- the envelope on an H100 (232,448 B a block) ----


@pytest.mark.parametrize("c, n_vals, smem", [
    (512, 2, 87_168), (512, 3, 87_168), (1024, 2, 174_208), (1024, 3, 174_208),
    (2048, 2, 348_288), (2048, 3, 348_288),
])
def test_fused_union_bytes_at_rseq_width(c, n_vals, smem):
    """The wide body's figure takes no value plane and no output row: its
    CTA holds one lane's key rows, the map and the flags."""
    assert hu.lexn_union_smem_bytes(18, n_vals, c) == smem
    assert hu.lexn_fits(c, 18, n_vals, LIMIT) == (c <= 1024)


@pytest.mark.parametrize("c, n_keys, n_vals, route", [
    (1024, 2, 2, None),      # the OpLog union fits at C = 1024
    (512, 18, 2, None),      # RSeq's fused union fits at C = 512 ...
    (512, 18, 3, None),
    (1024, 18, 2, None),     # ... and at C = 1024 (the wide body, 174,208 B)
    (1024, 18, 3, None),
    (2048, 18, 2, 1024),     # stripes at C = 2048: S = 2048 would need 344,064 B
    (4096, 24, 3, 1024),     # depth 8
])
def test_lexn_plan_at_the_h100_limit(c, n_keys, n_vals, route):
    assert hu.lexn_plan(c, n_keys, n_vals, LIMIT) == route
    if route is not None:
        assert hu.lexn_merge_smem_bytes(n_keys, route) <= LIMIT
        assert hu.lexn_merge_smem_bytes(n_keys, 2 * route) > LIMIT
        assert hu.lexn_compact_fits(2 * c, LIMIT)


def test_lexn_plan_raises_with_the_figures_past_the_limit():
    assert hu.lexn_merge_smem_bytes(18, 1024) == 172_032
    assert hu.lexn_compact_smem_bytes(2048, 8) == 49_408
    assert hu.lexn_compact_fits(2 * 65_536, LIMIT)
    with pytest.raises(ValueError, match="295168 B over 2C rows"):
        hu.lexn_plan(1 << 17, 18, 2, LIMIT)
    with pytest.raises(ValueError, match="does not fit 64 B"):
        hu.lexn_plan(1024, 18, 2, 64)
    assert hu._lexn_stripe_for(1024, 18, 64) == 0


@pytest.mark.parametrize("n_rows, lane_tile", [
    (2048, 8),               # RSeq's union epilogue at C = 1024: a sector a row
    (24_928, 8),             # the widest column at 8 lanes a block ...
    (24_929, 4),             # ... one row more takes 4
    (131_072, 1),            # C = 65,536: one lane a block
    (199_425, 0),            # past one lane's shared memory
])
def test_compaction_lane_tile_at_the_h100_limit(n_rows, lane_tile):
    """The compaction's lane tile is the widest whose flags (a byte a row
    a lane), gather window and scan sums fit the card's shared memory."""
    assert hu.lexn_compact_tile(n_rows, LIMIT) == lane_tile
    assert hu.lexn_compact_fits(n_rows, LIMIT) == (lane_tile > 0)
    if lane_tile:
        assert hu.lexn_compact_smem_bytes(n_rows, lane_tile) <= LIMIT


def test_striped_union_at_one_stripe_hands_the_merge_blocks_to_the_compaction(
        striped_case, monkeypatch):
    """At stripe = C the block network is one merge: its (P, 2C, L) key and
    value blocks go to the compaction as they are — no concatenation."""
    (ka, va, kb, vb), _ = striped_case
    merged, compacted = [], []
    merge, compact = hu.lexn_merge_columnar, hu.lexn_compact_columnar

    def spy_merge(*args):
        merged.append(merge(*args))
        return merged[-1]

    def spy_compact(keys, vals, out):
        compacted.append((keys, vals))
        return compact(keys, vals, out)

    monkeypatch.setattr(hu, "lexn_merge_columnar", spy_merge)
    monkeypatch.setattr(hu, "lexn_compact_columnar", spy_compact)
    hu.sorted_union_columnar_striped_lexn(tc(ka), tc(va), tc(kb), tc(vb), out_size=64,
                                          stripe=64)
    assert len(merged) == 1 and len(compacted) == 1
    assert compacted[0][0] is merged[0][0] and compacted[0][1] is merged[0][1]


@pytest.mark.parametrize("out_size", [16, 64, 128], ids=["overflow", "out=C", "out=2C"])
def test_striped_union_at_one_stripe_matches_the_twin_and_pallas(striped_case, out_size):
    """The striped union at stripe = C (one merge, then the compaction on
    its blocks) equals the fused twin and the JAX fused union."""
    (ka, va, kb, vb), (wk, wv, wnu) = striped_case
    gk, gv, gnu = hu.sorted_union_columnar_striped_lexn(
        tc(ka), tc(va), tc(kb), tc(vb), out_size=out_size, stripe=64)
    tk, tv, tnu = hu._lexn_union_plain(tc(ka), tc(va), tc(kb), tc(vb), out_size)
    assert_planes([p.numpy() for p in (*tk, *tv, tnu)], (*gk, *gv, gnu))
    assert_planes([np.asarray(p)[:out_size] for p in (*wk, *wv)], (*gk, *gv))
    np.testing.assert_array_equal(np.asarray(wnu), gnu.numpy())


def test_plane_cap_raises_before_any_launch(monkeypatch):
    """33 planes a side exceed csrc/lexn_union.cu's kMaxPlanes: the launch
    path refuses with the figure before it builds or loads anything."""
    def no_build(_name):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(hu._build, "load", no_build)
    planes = tuple(torch.full((8, 2), S, dtype=torch.int32) for _ in range(30))
    with pytest.raises(ValueError, match="33 key and value planes .* 32"):
        hu._lexn_union_cuda(planes, planes[:3], planes, planes[:3], 8)
    with pytest.raises(ValueError, match="33 key and value planes"):
        hu._lexn_merge_cuda(planes, planes[:3], planes, planes[:3])
    with pytest.raises(ValueError, match="33 key and value planes"):
        hu._lexn_compact_cuda(planes, planes[:3], 8)


def test_kernel_check_draw_at_32_planes_matches_pallas():
    """workload.lexn_pair, the draw of the card's kernel checks: sorted
    unique rows per lane, B inside A, all-padding lanes; at 29 key words and
    3 value planes (kMaxPlanes) the merge and compaction twins equal the
    JAX kernels in interpret mode."""
    from crdt_tpu_torch import workload

    ka, va, kb, vb = workload.lexn_pair(29, 3, 16, L, 4, b_inside_a=True,
                                        empty_lanes=(0, 77), device="cpu")
    for keys in (ka, kb):
        for lane in keys.permute(2, 1, 0).tolist():
            real = [tuple(r) for r in lane if r[0] != S]
            assert real == sorted(set(real))
    wk, wv = pu.lexn_merge_columnar(*map(jx, (ka, va, kb, vb)), interpret=True)
    gk, gv = hu.lexn_merge_columnar(ka, va, kb, vb)
    assert_planes(wk, gk)
    wk, wv, wnu = pu.lexn_compact_columnar(jx(gk), jx(gv), 16, interpret=True)
    ck, cv, cnu = hu.lexn_compact_columnar(gk, gv, 16)
    assert_planes((*wk, *wv, wnu), (*ck, *cv, cnu))
