"""The OR-Set member-mask kernel of csrc/set_member.cu against its plain
PyTorch twin (models.orset._columnar_member_mask_plain), bit for bit.
Needs a card (marked ``cuda``; skips without one) and imports no JAX, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_member_mask_cuda.py
"""
import numpy as np
import pytest
import torch

from crdt_tpu_torch import workload
from crdt_tpu_torch.models import orset
from crdt_tpu_torch.ops import hopper_union as hu
from crdt_tpu_torch.ops import pack

S = 2**31 - 1
ID_LIMIT = 1 << pack.ELEM_BITS
UNIVERSES = (0, 1, 10, 1_023, 1_024, 1_025, ID_LIMIT, 40_000)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the member-mask kernel has no CPU mode")


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
    return torch.from_numpy(packed), torch.from_numpy(removed)


def _kernel_and_twin(packed, removed, n_universe):
    """(kernel's mask, twin's mask, launches the kernel's call added)."""
    before = hu.LAUNCHES["member_mask"]
    got = orset.columnar_member_mask(packed.cuda(), removed.cuda(), n_universe)
    torch.cuda.synchronize()
    launched = hu.LAUNCHES["member_mask"] - before
    want = orset._columnar_member_mask_plain(packed, removed, n_universe)
    return got.cpu(), want, launched


@pytest.mark.cuda
@pytest.mark.parametrize("n_universe", UNIVERSES)
@pytest.mark.parametrize("c", (1, 8, 1_024, 2_048))
@pytest.mark.parametrize("lanes", (1, 31, 130, 4_099))
def test_member_mask_kernel_matches_twin_on_random_planes(lanes, c, n_universe):
    _need_card()
    rng = np.random.default_rng(lanes * 7 + c * 131 + n_universe)
    got, want, launched = _kernel_and_twin(*_planes(rng, c, lanes, n_universe), n_universe)
    assert got.dtype == torch.bool and got.shape == (n_universe, lanes)
    assert torch.equal(got, want)
    assert launched == (1 if n_universe else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("c, lanes, n_universe", [
    (8, 130, 10), (8, 4_099, 1_024), (1_024, 4_099, 1_024), (1_024, 131, 1_025),
    (1_024, 4_099, ID_LIMIT),
])
def test_member_mask_kernel_matches_twin_on_joined_swarms(c, lanes, n_universe):
    _need_card()
    pool = workload.set_pool(c + lanes)
    a = orset.stack_to_columnar(workload.set_swarm(pool, lanes, c, 1, device="cuda").sets)
    b = orset.stack_to_columnar(workload.set_swarm(pool, lanes, c, 2, device="cuda").sets)
    for packed, removed in (a, orset.columnar_join(*a, *b, engine="sort")[:2]):
        got, want, launched = _kernel_and_twin(packed.cpu(), removed.cpu(), n_universe)
        assert torch.equal(got, want)
        assert launched == 1


@pytest.mark.cuda
def test_member_mask_kernel_writes_every_byte():
    """The mask comes from torch.empty: a caching allocator's block that
    held ones must come back all false where no tag is live."""
    _need_card()
    junk = torch.ones((4_099 * 1_025 + 64,), dtype=torch.bool, device="cuda")
    del junk
    packed = torch.full((8, 4_099), S, dtype=torch.int32, device="cuda")
    mask = orset.columnar_member_mask(packed, torch.zeros_like(packed), 1_025)
    torch.cuda.synchronize()
    assert not bool(mask.any())


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ("dtype", "contiguous", "shape", "device"))
def test_member_mask_kernel_refuses_planes_it_does_not_take(bad):
    _need_card()
    packed = torch.full((8, 12), S, dtype=torch.int32, device="cuda")
    removed = torch.zeros((8, 12), dtype=torch.int32, device="cuda")
    err = ValueError
    if bad == "dtype":
        removed, err = removed.to(torch.int64), TypeError
    elif bad == "contiguous":
        packed = torch.full((12, 8), S, dtype=torch.int32, device="cuda").T
    elif bad == "shape":
        removed = removed[:, :11].contiguous()
    else:
        removed = removed.cpu()
    before = hu.LAUNCHES["member_mask"]
    with pytest.raises(err):
        orset.columnar_member_mask(packed, removed, 4)
    assert hu.LAUNCHES["member_mask"] == before
