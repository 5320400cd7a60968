"""The hand-written CUDA lexN merge, compaction and union at RSeq's width
against their plain PyTorch twins, bit for bit, and the striped and auto
paths on the card.  Needs a card (marked ``cuda``; skips without one) and
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_rseq_cuda.py
"""
import pytest
import torch

from crdt_tpu_torch import workload
from crdt_tpu_torch.models import rseq_columnar as rc
from crdt_tpu_torch.ops import hopper_union as hu


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lexN kernels have no CPU mode")


def operands(c, lanes, n_vals, seed):
    """Two seq_swarm draws on the card at capacity c, stacked: (keys,
    vals) of each side, 18 key words and n_vals value planes (the third
    is the GC join's src marker)."""
    pool = workload.seq_pool(seed, n_elements=min(1000, c))
    sides = []
    for k in (1, 2):
        col = rc.stack(workload.seq_swarm(pool, lanes, c, seed + k, device="cuda").states)
        vals = [col.elem, col.removed, (col.keys[0] != 2**31 - 1).to(torch.int32) * k]
        sides += [tuple(col.keys), tuple(vals[:n_vals])]
    return sides


def same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("c, lanes, n_vals", [
    (64, 1, 2), (64, 130, 3), (1024, 300, 2), (1024, 257, 3),
])
def test_merge_and_compact_match_their_twins(c, lanes, n_vals):
    need_card()
    ka, va, kb, vb = operands(c, lanes, n_vals, c + lanes)
    before = dict(hu.LAUNCHES)
    mk, mv = hu.lexn_merge_columnar(ka, va, kb, vb)
    tk, tv = hu._lexn_merge_plain(ka, va, kb, vb)  # both put A's copy first
    assert mk.shape == (18, 2 * c, lanes) and mv.shape == (n_vals, 2 * c, lanes)
    same((*mk, *mv), (*tk, *tv))
    for out in (c, 2 * c, c // 4):
        got = hu.lexn_compact_columnar(mk, mv, out)
        want = hu._lexn_compact_plain(mk, mv, out)
        same((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))
    torch.cuda.synchronize()
    assert hu.LAUNCHES["lexn_merge"] == before["lexn_merge"] + 1
    assert hu.LAUNCHES["lexn_compact"] == before["lexn_compact"] + 3


@pytest.mark.cuda
@pytest.mark.parametrize("n_vals", [2, 3])
def test_fused_union_at_rseq_width_matches_its_twin(n_vals):
    need_card()
    ka, va, kb, vb = operands(512, 200, n_vals, 7)
    for out in (512, None, 64):
        got = hu.sorted_union_columnar_fused_lexn(ka, va, kb, vb, out_size=out)
        want = hu._lexn_union_plain(ka, va, kb, vb, 1024 if out is None else out)
        same((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 7, 9, 130, 10_240])
@pytest.mark.parametrize("c", [512, 1024])
def test_wide_union_matches_its_twin(c, lanes):
    """The wide body (an 8-CTA cluster a tile of 8 lanes; 512 threads two
    CTAs an SM at C = 512, 1,024 threads at 1024) at lane counts below,
    at and past a cluster, at (18, 2) and (18, 3), out = C/2, C and 2C."""
    need_card()
    for n_vals in (2, 3):
        ka, va, kb, vb = operands(c, lanes, n_vals, c + lanes + n_vals)
        assert hu.lexn_union_body(18, n_vals, c, c, hu.smem_limit(ka[0].device))[1] == 0
        for out in (c // 2, c, 2 * c):
            before = hu.LAUNCHES["lexn_union"]
            got = hu.sorted_union_columnar_lexn_auto(ka, va, kb, vb, out_size=out)
            want = hu._lexn_union_plain(ka, va, kb, vb, out)
            same((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))
            assert hu.LAUNCHES["lexn_union"] == before + 1
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys, c, lanes", [(2, 2048, 130), (2, 4096, 9), (5, 64, 9),
                                              (18, 1024, 2), (18, 128, 17), (18, 256, 130)])
def test_wide_union_edges_match_the_twin(n_keys, c, lanes):
    """The wide body past the tile: (2, 2) at C = 2048 and 4096, 5 key
    words, and small capacities (8 and 4 CTAs an SM); lanes all padding
    beside lanes whose B rows all lie in A."""
    need_card()
    for kw in ({}, {"b_inside_a": True, "empty_lanes": (0, lanes - 1)}):
        pair = workload.lexn_pair(n_keys, 2, c, lanes, c + n_keys, device="cuda", **kw)
        for out in (c // 2, c, 2 * c):
            got = hu.sorted_union_columnar_fused_lexn(*pair, out_size=out)
            want = hu._lexn_union_plain(*pair, out)
            same((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_striped_and_auto_match_the_fused_twin():
    need_card()
    ka, va, kb, vb = operands(1024, 100, 3, 11)
    want = hu._lexn_union_plain(ka, va, kb, vb, 1024)
    before = dict(hu.LAUNCHES)
    got = hu.sorted_union_columnar_striped_lexn(ka, va, kb, vb, out_size=1024, stripe=256)
    same((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))
    assert hu.LAUNCHES["lexn_merge"] - before["lexn_merge"] == 12  # M·log2(2M), M = 4
    got = hu.sorted_union_columnar_lexn_auto(ka, va, kb, vb, out_size=1024)
    same((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))
    # C = 1024 takes the wide body's fused union, no merge
    assert hu.LAUNCHES["lexn_union"] == before["lexn_union"] + 1
    assert hu.LAUNCHES["lexn_merge"] - before["lexn_merge"] == 12


@pytest.mark.cuda
def test_card_refuses_past_its_shared_memory_limit():
    """The launchers take the envelope's byte counts: a shape past the
    card's opt-in limit is refused with the figure and counted nowhere."""
    need_card()
    limit = hu.smem_limit(torch.device("cuda"))
    s = 2048
    planes = [torch.full((s, 2), 2**31 - 1, dtype=torch.int32, device="cuda")] * 20
    before = dict(hu.LAUNCHES)
    merge_bytes = hu.lexn_merge_smem_bytes(18, s)
    if merge_bytes > limit:
        with pytest.raises(RuntimeError, match=f"{merge_bytes} B of shared memory"):
            hu.lexn_merge_columnar(planes[:18], planes[18:], planes[:18], planes[18:])
    union_bytes = hu.lexn_union_smem_bytes(18, 2, s)
    with pytest.raises(RuntimeError, match=f"{union_bytes} B of shared memory"):
        hu.sorted_union_columnar_fused_lexn(planes[:18], planes[18:], planes[:18], planes[18:])
    assert hu.LAUNCHES == before


def merge_then_compact(ka, va, kb, vb, outs):
    """Both kernels against their twins on the same operands: the merge,
    then the compaction of the merged planes at every ``outs``."""
    mk, mv = hu.lexn_merge_columnar(ka, va, kb, vb)
    tk, tv = hu._lexn_merge_plain(ka, va, kb, vb)
    same((*mk, *mv), (*tk, *tv))
    for out in outs:
        got = hu.lexn_compact_columnar(mk, mv, out)
        want = hu._lexn_compact_plain(mk, mv, out)
        same((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 7, 9, 130, 257])
def test_lane_counts_that_split_a_tile_or_a_cluster(lanes):
    """Tiles and clusters of 8 lanes: a ragged last tile, a tile of one."""
    need_card()
    c = 256
    merge_then_compact(*workload.lexn_pair(18, 3, c, lanes, lanes, device="cuda"),
                       (c // 4, c, 2 * c))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [9, 257])
def test_row_sliced_planes_off_16_byte_alignment(lanes):
    """Stripe views: planes that start one row into a (C + 1, L) block,
    so with an odd L neither the base nor the row stride is 16 B aligned."""
    need_card()
    c = 128
    sides = []
    for block in workload.lexn_pair(18, 2, c, lanes, 3, device="cuda"):
        big = torch.zeros((block.shape[0], c + 1, lanes), dtype=torch.int32, device="cuda")
        big[:, 1:] = block
        sides.append(tuple(p[1:] for p in big))
    assert sides[0][0].data_ptr() % 16 != 0
    merge_then_compact(*sides, (c // 4, c, 2 * c))
    merged = [torch.zeros((2 * c + 1, lanes), dtype=torch.int32, device="cuda")
              for _ in range(20)]
    mk, mv = hu.lexn_merge_columnar(*sides)
    for dst, src in zip(merged, (*mk, *mv)):
        dst[1:] = src
    views = [m[1:] for m in merged]
    got = hu.lexn_compact_columnar(views[:18], views[18:], c)
    want = hu._lexn_compact_plain(views[:18], views[18:], c)
    same((*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys, n_vals", [(29, 3), (32, 0), (1, 31)])
def test_the_plane_cap_of_32(n_keys, n_vals):
    """kMaxPlanes planes a side; key words compared deep into the key."""
    need_card()
    c = 128
    merge_then_compact(*workload.lexn_pair(n_keys, n_vals, c, 130, n_keys, device="cuda"),
                       (c // 4, c, 2 * c))


@pytest.mark.cuda
@pytest.mark.parametrize("b_inside_a", [False, True])
def test_all_padding_lanes_and_b_inside_a(b_inside_a):
    """Lanes that hold nothing on either side, beside lanes where every row
    of B is also a row of A (each of its rows a duplicate to OR in)."""
    need_card()
    c = 256
    pair = workload.lexn_pair(18, 3, c, 130, 5, b_inside_a=b_inside_a,
                              empty_lanes=(0, 7, 8, 64, 129), device="cuda")
    merge_then_compact(*pair, (c // 4, c, 2 * c))
