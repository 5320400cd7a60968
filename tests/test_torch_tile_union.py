"""The host-side figures of the lane-tile union (csrc/tile_union.cuh), the
body of kernel 2 (``sorted_union_columnar_fused``), of kernel 1 at narrow
keys (``sorted_union_columnar_fused_lexn``) and, in its keep-all mode, of
kernel 6 (``bitonic_merge_columnar``): the plans and shared memory a CTA
that the launchers pass, at the H100's 232,448 B a block.
Pure functions of the shapes, so they run without a card; the kernels
themselves are held against their twins on the card by
test_torch_hopper_kernel.py and test_torch_set_kernels.py."""
import pytest

from crdt_tpu_torch.ops import hopper_union as hu

LIMIT = hu.HOPPER_SMEM_OPTIN


def layout_bytes(n_keys, n_vals, c, out, lt, stages, stage_vals, keep_all=False):
    """The tile body's shared memory counted part by part, as
    tile_union.cuh lays it out: key buffers, value buffer, map (a 32-bit
    source and OR partner, or in keep-all mode a 16-bit source), scan."""
    keys = stages * 2 * n_keys * c * lt * 4
    vals = stage_vals * 2 * n_vals * c * lt * 4
    gather_map = out * lt * (2 if keep_all else 4)
    scan = (512 // 32) * lt * 4 + lt * 4
    return keys + vals + gather_map + scan


def wide_layout_bytes(n_keys, c):
    """The wide body's shared memory counted part by part, as
    lexn_union.cu lays it out: both operands' key rows of one lane (n_keys
    rounded up to 4 words), the map (a word a merged row), the scan's 32
    warp sums and a flag byte a merged row."""
    kp = -(-n_keys // 4) * 4
    return 2 * c * kp * 4 + 2 * c * 4 + 32 * 4 + 2 * c


def template_one_lane_bytes(c, rows_out):
    """The first template's shared memory at one lane a CTA (the figure it
    launched with past its 113 KB budget): four input planes and two
    output planes, each padded by 32 words, and two counters."""
    return 4 * (4 * (c + 32) + 2 * (rows_out + 32) + 2)


@pytest.mark.parametrize("c, out, plan, smem", [
    (1024, 1024, (8, 2, 1), 229_920),  # the OR-Set join: 8 lanes, keys double-buffered, values staged
    (1024, 2048, (8, 1, 1), 197_152),  # untruncated: one key buffer
    (1024, 512, (8, 2, 1), 213_536),   # overflow at out = C/2
    (2048, 2048, (8, 1, 0), 197_152),  # values gathered from device memory
    (8192, 8192, (2, 1, 0), 196_744),
    (64, 64, (8, 2, 1), 14_880),
])
def test_set_union_plan_at_the_h100_limit(c, out, plan, smem):
    assert hu.set_union_plan(c, out, LIMIT) == plan
    assert hu.set_union_smem_bytes(c, out) == smem == layout_bytes(1, 1, c, out, *plan)
    assert smem <= LIMIT


def test_set_union_plan_past_the_limit_keeps_the_smallest_figure():
    """C = 16,384 untruncated fits no tile: the plan is one lane, one key
    buffer, values gathered, and its figure (past the limit) is what the
    refused launch reports."""
    assert hu.set_union_plan(16_384, 32_768, LIMIT) == (1, 1, 0)
    assert hu.set_union_smem_bytes(16_384, 32_768) == 262_212 > LIMIT


@pytest.mark.parametrize("c, out", [(64, 32), (1024, 1024), (1024, 2048), (16_384, 32_768)])
def test_set_union_plan_always_names_a_lane_tile(c, out):
    """The host names a lane tile for every one-segment union, even past
    the limit, where the launch is refused with that plan's figure."""
    assert hu.set_union_plan(c, out, LIMIT)[0] in hu.TILE_LANES


@pytest.mark.parametrize("n_keys, n_vals, c, out, body, smem", [
    (2, 2, 1024, 1024, (8, 1, 0), 164_384),   # the OpLog's (hi, lo) union: the tile body
    (2, 2, 1024, 2048, (8, 1, 0), 197_152),
    (2, 2, 512, 512, (8, 2, 1), 213_536),
    (2, 2, 64, 64, (8, 2, 1), 27_168),
    (1, 3, 256, 256, (8, 2, 1), 90_656),
    (18, 2, 512, 512, (8, 0, 2), 87_168),     # RSeq's (18, 2): the wide body, two CTAs an SM
    (18, 3, 512, 1024, (8, 0, 2), 87_168),
    (18, 2, 1024, 1024, (8, 0, 1), 174_208),  # one CTA an SM
    (5, 2, 64, 64, (8, 0, 8), 4_864),         # past the tile's 4 key words
    (2, 2, 2048, 2048, (8, 0, 2), 86_144),    # 8 lanes of keys do not fit the tile
    (2, 2, 4096, 8192, (8, 0, 1), 172_160),
    (2, 2, 8192, 16_384, (8, 0, 1), 344_192),  # refused by the card
])
def test_lexn_union_body_at_the_h100_limit(n_keys, n_vals, c, out, body, smem):
    assert hu.lexn_union_body(n_keys, n_vals, c, out, LIMIT) == body
    assert hu.lexn_union_smem_bytes(n_keys, n_vals, c, out) == smem
    if body[1]:
        assert smem == layout_bytes(n_keys, n_vals, c, out, *body)
    else:
        assert smem == wide_layout_bytes(n_keys, c) == hu.lexn_wide_smem_bytes(n_keys, c)
        # the most CTAs an SM (8, 4, 2, 1) whose shared memory fits its
        # 228 KB, each with 1 KB reserved
        assert body[2] == next((k for k in (8, 4, 2) if k * (smem + 1024) <= 228 * 1024), 1)


@pytest.mark.parametrize("c, n_keys, n_vals", [
    (256, 2, 2), (1024, 2, 2), (2048, 2, 2), (4096, 2, 2), (512, 18, 2), (512, 18, 3),
])
def test_fused_routes_are_unchanged_by_the_tile_body(c, n_keys, n_vals):
    """The union's route (fused or striped) depends only on whether some
    body fits: the OpLog's split stays fused up to C = 4096 and RSeq's
    (18, .) at C = 512, as before the tile body."""
    assert hu.lexn_plan(c, n_keys, n_vals, LIMIT) is None
    assert hu.lexn_fits(c, n_keys, n_vals, LIMIT)
    assert hu.lexn_union_smem_bytes(n_keys, n_vals, c) <= LIMIT


@pytest.mark.parametrize("c, plan, smem", [
    (8, (8, 2, 1), 2_336),
    (64, (8, 2, 1), 14_880),
    (1024, (8, 2, 1), 229_920),   # kernel 2's own plan: two key stages, values staged
    (2048, (8, 1, 0), 197_152),
    (4096, (4, 1, 0), 196_880),
    (8192, (2, 1, 0), 196_744),
    (16_384, (1, 1, 0), 196_676),  # past the first template's limit, now one lane
])
def test_merge_plan_at_the_h100_limit(c, plan, smem):
    """Kernel 6 on the keep-all tile: 2C output rows, a half-word map."""
    assert hu.merge_plan(c, LIMIT) == plan
    assert hu.merge_smem_bytes(c) == smem == layout_bytes(1, 1, c, 2 * c, *plan, keep_all=True)
    assert smem <= LIMIT


def test_merge_half_word_map_buys_the_second_key_stage():
    """At C = 1024 a word map would take (8, 2, 1) past the card's limit
    (262,688 B) and leave (8, 1, 1) at 197,152 B; the 16-bit source brings
    (8, 2, 1) back to 229,920 B."""
    assert hu.tile_union_smem_bytes(1, 1, 1024, 2048, (8, 2, 1)) == 262_688 > LIMIT
    assert hu._tile_plan(1, 1, 1024, 2048, hu.TILE_LANES, LIMIT) == (8, 1, 1)
    assert hu.tile_union_smem_bytes(1, 1, 1024, 2048, (8, 1, 1)) == 197_152
    assert hu.tile_union_smem_bytes(1, 1, 1024, 2048, (8, 2, 1), keep_all=True) == 229_920


def test_merge_plan_past_the_envelope_keeps_the_smallest_figure():
    """C = 32,768 is past the tile's 16,384 rows an operand: the plan is one
    lane, one key buffer, values gathered, and its figure (past the limit)
    is what the refused launch reports."""
    assert hu.merge_plan(32_768, LIMIT) == (1, 1, 0)
    assert hu.merge_smem_bytes(32_768) == 393_284 > LIMIT


@pytest.mark.parametrize("c", [1 << k for k in range(16)])
def test_merge_plan_fits_wherever_the_template_launched(c):
    """Every capacity the first template merged at one lane a CTA, the
    keep-all tile merges within the card's limit too, and at one lane in
    fewer bytes."""
    one_lane = hu.tile_union_smem_bytes(1, 1, c, 2 * c, (1, 1, 0), keep_all=True)
    assert one_lane < template_one_lane_bytes(c, 2 * c)
    if template_one_lane_bytes(c, 2 * c) <= LIMIT:
        assert hu.merge_smem_bytes(c) <= LIMIT
    assert (hu.merge_smem_bytes(c) <= LIMIT) == (c <= hu.TILE_MAX_ROWS)
