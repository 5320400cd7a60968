"""The host-side figures of kernel 3's wide-lane segment body
(csrc/set_union.cu, ``bucketed_union_columnar``): the plan — lanes a CTA,
input buffers and shared-memory bytes — that the launcher passes, at the
H100's 232,448 B a block, pinned against a part-by-part count of the
layout.  Pure functions of the shapes, so they run without a card; the
kernel itself is held against its twin on the card by
test_torch_set_kernels.py."""
import pytest

from crdt_tpu_torch.ops import hopper_union as hu

from tests.test_torch_tile_union import template_one_lane_bytes

LIMIT = hu.HOPPER_SMEM_OPTIN


def layout_bytes(wb, out_r, width, stages):
    """The segment body's shared memory counted part by part: ``stages``
    buffers of one bucket of four input planes (keys and values of A and
    B), and one buffer of the bucket's two output planes."""
    inputs = stages * 4 * wb * width * 4
    outputs = 2 * out_r * width * 4
    return inputs + outputs


@pytest.mark.parametrize("c, n_buckets, out_r, plan", [
    (1024, 64, 16, (256, 3, 229_376)),  # the resident chain: out_r = Wb
    (1024, 64, 32, (256, 2, 196_608)),  # the bucket engine: out_r = 2 Wb
    (1024, 64, 0, (256, 3, 196_608)),
    (1024, 64, 5, (256, 3, 206_848)),
    (48, 3, 16, (256, 3, 229_376)),     # C need not be a power of two
    (64, 64, 1, (256, 4, 18_432)),      # Wb = 1
    (64, 2, 0, (128, 2, 131_072)),      # 256 lanes would hold one buffer only
    (32, 1, 0, (256, 1, 131_072)),      # one bucket: one buffer
    (512, 2, 256, (16, 2, 163_840)),    # Wb = 256: fewer than 32 lanes a CTA
    (512, 2, 512, (16, 2, 196_608)),
    (256, 1, 512, (16, 1, 131_072)),
    (4096, 16, 512, (16, 2, 196_608)),
])
def test_bucketed_union_plan_at_the_h100_limit(c, n_buckets, out_r, plan):
    assert hu.bucketed_union_plan(c, n_buckets, out_r, LIMIT) == plan
    width, stages, smem = plan
    assert smem == layout_bytes(c // n_buckets, out_r, width, stages) <= LIMIT
    assert smem == hu.segment_union_smem_bytes(c // n_buckets, out_r, width, stages)


def test_bucketed_union_plan_past_the_limit_keeps_the_smallest_figure():
    """One bucket of 16,384 rows, untruncated, fits no plan: the plan is one
    lane and one buffer, and its figure (past the limit) is what the
    refused launch reports."""
    assert hu.bucketed_union_plan(16_384, 1, 32_768, LIMIT) == (1, 1, 524_288)
    assert 524_288 == layout_bytes(16_384, 32_768, 1, 1) > LIMIT


@pytest.mark.parametrize("c, n_buckets", [(1024, 64), (1024, 2), (48, 3), (4096, 1)])
def test_bucketed_union_plan_never_buffers_more_than_the_buckets(c, n_buckets):
    for out_r in (0, 1, c // n_buckets, 2 * c // n_buckets):
        width, stages, _ = hu.bucketed_union_plan(c, n_buckets, out_r, LIMIT)
        assert 1 <= stages <= min(n_buckets, hu.SEGMENT_MAX_STAGES)
        assert width in hu.SEGMENT_WIDTHS


@pytest.mark.parametrize("c", [48, 64, 1024, 4096, 8192, 12_288])
def test_bucketed_union_plan_fits_wherever_the_template_launched(c):
    """Every bucketed shape that the first template launched at one lane a
    CTA (B buckets of a power-of-two Wb, out_r from 0 to 2 Wb) has a
    segment plan within the card's limit, in fewer bytes at one lane."""
    shapes = 0
    wb = 1
    while wb <= c:
        if c % wb == 0:
            n_buckets = c // wb
            for out_r in sorted({0, 1, wb // 2, wb, 2 * wb}):
                if template_one_lane_bytes(c, n_buckets * out_r) <= LIMIT:
                    shapes += 1
                    assert hu.segment_union_smem_bytes(wb, out_r, 1, 1) < \
                        template_one_lane_bytes(c, n_buckets * out_r)
                    assert hu.bucketed_union_plan(c, n_buckets, out_r, LIMIT)[2] <= LIMIT
        wb *= 2
    assert shapes > 0
