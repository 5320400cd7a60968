"""The OR-Set member mask's host side (models.orset.columnar_member_mask,
ops.hopper_union's member-mask plan and checks) on the CPU: the plan of
csrc/set_member.cu at the H100's shared-memory limit, and the CPU route,
which launches nothing and equals the JAX package's columnar_member_mask
bit for bit.  The kernel itself is held against the twin on the card in
tests/test_torch_member_mask_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import orset as jos
from crdt_tpu_torch.models import orset as tos
from crdt_tpu_torch.ops import hopper_union as hu
from crdt_tpu_torch.ops import pack

S = 2**31 - 1
ID_LIMIT = 1 << pack.ELEM_BITS


def test_member_mask_plan_fits_the_h100_for_every_universe():
    for n in range(0, ID_LIMIT + 600):
        lanes, smem = hu.member_mask_plan(n, hu.HOPPER_SMEM_OPTIN)
        words = (min(n, ID_LIMIT) + 31) // 32
        assert lanes % 32 == 0 and 32 <= lanes <= hu.MEMBER_MASK_LANES, (n, lanes)
        assert smem == 4 * words * lanes <= hu.HOPPER_SMEM_OPTIN, (n, smem)
        # the widest block whose bitmaps fit
        assert lanes == hu.MEMBER_MASK_LANES or 4 * words * (lanes + 32) > hu.HOPPER_SMEM_OPTIN


@pytest.mark.parametrize("n, lanes, smem", [
    (1, 1_024, 4_096), (1_024, 1_024, 131_072), (1_025, 1_024, 135_168),
    (1_792, 1_024, 229_376), (1_793, 992, 226_176), (ID_LIMIT, 96, 196_608),
    (40_000, 96, 196_608),
])
def test_member_mask_plan_at_pinned_universes(n, lanes, smem):
    assert hu.member_mask_plan(n, hu.HOPPER_SMEM_OPTIN) == (lanes, smem)
    assert hu.member_mask_id_rows(n) == min(n, ID_LIMIT)


def test_member_mask_plan_refuses_a_card_without_room_for_32_lanes():
    with pytest.raises(ValueError, match="shared memory"):
        hu.member_mask_plan(ID_LIMIT, 4 * 512 * 32 - 1)


def _planes(rng, c, lanes, n_universe):
    """Random (packed, removed) int32 planes: full-range words (negatives
    included), keys whose element id sits at, below and past
    ``n_universe``, SENTINEL rows anywhere in a column, and removed values
    other than 0 and 1."""
    packed = rng.integers(-2**31, 2**31, (c, lanes), dtype=np.int64).astype(np.int32)
    lo = min(max(n_universe - 3, 0), ID_LIMIT - 6)
    near = rng.integers(lo, lo + 6, (c, lanes))
    ids = np.where(rng.random((c, lanes)) < 0.5, near, rng.integers(0, ID_LIMIT, (c, lanes)))
    tags = pack.pack_tags(*(torch.from_numpy(x.astype(np.int32)) for x in
                            (ids, rng.integers(0, 64, (c, lanes)),
                             rng.integers(0, 2048, (c, lanes))))).numpy()
    packed = np.where(rng.random((c, lanes)) < 0.7, tags, packed)
    packed[rng.random((c, lanes)) < 0.15] = S
    removed = rng.choice(np.array([0, 0, 0, 1, 2, -1, -2**31], np.int32), (c, lanes))
    return packed, removed


@pytest.mark.parametrize("c, lanes, n_universe", [
    (1, 37, 10), (8, 37, 1), (64, 37, 10), (64, 130, 63), (128, 37, 1_024), (16, 5, 0),
])
def test_cpu_member_mask_launches_nothing_and_matches_jax(monkeypatch, c, lanes, n_universe):
    def no_build(_name):
        raise AssertionError("the CPU route built a kernel library")

    monkeypatch.setattr(hu._build, "load", no_build)
    rng = np.random.default_rng(c * 1_000 + lanes + n_universe)
    packed, removed = _planes(rng, c, lanes, n_universe)
    before = dict(hu.LAUNCHES)
    got = tos.columnar_member_mask(torch.from_numpy(packed), torch.from_numpy(removed),
                                   n_universe)
    assert hu.LAUNCHES == before
    want = jos.columnar_member_mask(jnp.asarray(packed), jnp.asarray(removed), n_universe)
    assert got.dtype == torch.bool and got.shape == (n_universe, lanes)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("bad, err", [
    ("dtype", TypeError), ("contiguous", ValueError), ("shape", ValueError),
    ("rank", ValueError),
])
def test_member_mask_empty_refuses_planes_the_kernel_does_not_take(bad, err):
    packed = torch.full((8, 12), S, dtype=torch.int32)
    removed = torch.zeros((8, 12), dtype=torch.int32)
    if bad == "dtype":
        removed = removed.to(torch.int64)
    elif bad == "contiguous":
        packed = torch.full((12, 8), S, dtype=torch.int32).T
    elif bad == "shape":
        removed = removed[:, :11].contiguous()
    else:
        packed, removed = packed[0], removed[0]
    with pytest.raises(err):
        hu.member_mask_empty(packed, removed, 4)


def test_member_mask_empty_allocates_the_mask():
    packed = torch.full((8, 12), S, dtype=torch.int32)
    mask = hu.member_mask_empty(packed, torch.zeros_like(packed), 5)
    assert mask.shape == (5, 12) and mask.dtype == torch.bool and mask.is_contiguous()
