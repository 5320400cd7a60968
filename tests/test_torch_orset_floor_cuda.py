"""The hand-written CUDA kernels of csrc/set_floor.cu — the OR-Set union
floors floor_union and bucketed_floor_union — against their plain PyTorch
twins, bit for bit.  Needs a card (marked ``cuda``; skips without one) and
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_orset_floor_cuda.py
"""
import numpy as np
import pytest
import torch

from crdt_tpu_torch.ops import hopper_union as hu
from crdt_tpu_torch.ops import orset_floor as of

S = 2**31 - 1


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the set_floor kernels have no CPU mode")


def _planes(draw, c, lanes, seed):
    """Both operands' (keys, vals): the OR-Set floor draw (sorted uniform
    [0, 2^30) keys, the upper half SENTINEL, vals = the draw & 1) or
    full-range int32 with a fifth of the keys SENTINEL."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        if draw == "orset":
            kk = np.sort(rng.integers(0, 1 << 30, (lanes, c)), axis=1).T.astype(np.int32)
            out += [np.where(np.arange(c)[:, None] < c // 2, kk, S).astype(np.int32),
                    (kk & 1).astype(np.int32)]
        else:
            keys = rng.integers(-2**31, 2**31, (c, lanes)).astype(np.int32)
            keys[rng.random((c, lanes)) < 0.2] = S
            out += [keys, rng.integers(-2**31, 2**31, (c, lanes)).astype(np.int32)]
    return [np.ascontiguousarray(p) for p in out]


def _both(fn, planes, arg):
    got = fn(*(torch.from_numpy(p).cuda() for p in planes), arg)
    torch.cuda.synchronize()
    want = fn(*(torch.from_numpy(p) for p in planes), arg)
    return [g.cpu() for g in got], list(want)


@pytest.mark.cuda
@pytest.mark.parametrize("draw, c, lanes, out", [
    ("orset", 1024, 300, 1024), ("orset", 1024, 300, 512), ("full_range", 1024, 300, 1024),
    ("full_range", 64, 1000, 64), ("orset", 2048, 130, 2048), ("full_range", 2048, 130, 1024),
    ("full_range", 1024, 1, 1024), ("full_range", 16, 1000, 32), ("full_range", 1, 33, 2),
])
def test_floor_kernel_matches_twin(draw, c, lanes, out):
    _need_card()
    planes = _planes(draw, c, lanes, seed=c + lanes + out)
    before = hu.LAUNCHES["floor_union"]
    got, want = _both(of.floor_union, planes, out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert hu.LAUNCHES["floor_union"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("draw, c, lanes, n_buckets", [
    ("orset", 1024, 300, 64), ("full_range", 1024, 300, 2), ("full_range", 1024, 300, 128),
    ("full_range", 64, 1000, 4), ("orset", 2048, 130, 128), ("full_range", 1024, 1, 64),
    ("full_range", 32, 77, 32), ("full_range", 16, 1000, 1),
])
def test_bucketed_floor_kernel_matches_twin(draw, c, lanes, n_buckets):
    _need_card()
    planes = _planes(draw, c, lanes, seed=3 * c + lanes + n_buckets)
    before = hu.LAUNCHES["bucketed_floor_union"]
    got, want = _both(of.bucketed_floor_union, planes, n_buckets)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert hu.LAUNCHES["bucketed_floor_union"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("c, lanes, out", [
    (1024, 1, 1024), (1024, 7, 0), (1024, 9, 1023), (1024, 127, 2048), (1024, 130, 1),
    (1024, 4097, 1024), (8, 1, 16), (8, 4097, 5), (8192, 7, 8192), (8192, 1, 3),
    (4096, 9, 4096), (256, 130, 255),
])
def test_floor_tile_body_edges(c, lanes, out):
    """Kernel 7's tile body at ragged lane counts (a tile of 8 split, one
    lane), out_size 0, odd, C and 2C, C = 8 (one thread a lane) up to 8,192
    (one lane a tile), on full-range int32 with values past 2^15."""
    _need_card()
    planes = _planes("full_range", c, lanes, seed=7 * c + lanes + out)
    got, want = _both(of.floor_union, planes, out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("c, lanes, n_buckets", [
    (1024, 1, 64), (1024, 7, 1024), (1024, 9, 2), (1024, 127, 1), (1024, 130, 64),
    (1024, 4097, 64), (8, 130, 8), (8, 9, 1), (8192, 7, 512), (8192, 3, 2), (8192, 1, 1),
    (16, 4097, 1), (32, 130, 1), (1024, 259, 128),
])
def test_bucketed_floor_edges(c, lanes, n_buckets):
    """Kernel 8 on the segment walk (Wb <= 16: B = 64 and C, Wb = 1) and on
    the tile body (B = 1 and 2 at large C), at ragged lane counts that
    split a CTA of 256 lanes, full-range int32."""
    _need_card()
    planes = _planes("full_range", c, lanes, seed=11 * c + lanes + n_buckets)
    got, want = _both(of.bucketed_floor_union, planes, n_buckets)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_planes_off_16_byte_alignment_take_the_scalar_loads():
    """Contiguous planes that start 4 B into their storage: the kernel must
    not use its 16 B loads on them, and still equal the twin."""
    _need_card()
    c, lanes = 1024, 300
    planes = _planes("full_range", c, lanes, seed=5)
    shifted = []
    for p in planes:
        buf = torch.empty(c * lanes + 1, dtype=torch.int32, device="cuda")
        view = buf[1:].view(c, lanes)
        view.copy_(torch.from_numpy(p))
        shifted.append(view)
    assert all(t.data_ptr() % 16 for t in shifted)
    for fn, arg in ((of.floor_union, c), (of.bucketed_floor_union, 64),
                    (of.bucketed_floor_union, 2)):
        got = fn(*shifted, arg)
        torch.cuda.synchronize()
        want = fn(*(torch.from_numpy(p) for p in planes), arg)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_refusals_raise_before_any_launch():
    """Bad shapes raise in the wrapper; a capacity past the tile body's
    envelope (C > 8,192) is refused by the launcher, with the plan's figure;
    none counts a launch."""
    _need_card()
    before = dict(hu.LAUNCHES)

    def planes(c, lanes, dtype=torch.int32):
        return [torch.zeros((c, lanes), dtype=dtype, device="cuda") for _ in range(4)]

    with pytest.raises(ValueError, match="power of two"):
        of.floor_union(*planes(48, 4), 48)
    with pytest.raises(TypeError, match="int32"):
        of.floor_union(*planes(64, 4, torch.int64), 64)
    with pytest.raises(ValueError, match="contiguous"):
        of.floor_union(*planes(64, 8)[:3], torch.zeros((8, 64), dtype=torch.int32,
                                                        device="cuda").T, 64)
    with pytest.raises(ValueError, match="divide"):
        of.bucketed_floor_union(*planes(64, 4), 3)
    with pytest.raises(RuntimeError, match="401408 B of shared memory"):
        of.floor_union(*planes(16384, 1), 16384)
    with pytest.raises(RuntimeError, match="tile body, 1 lanes a tile"):
        of.bucketed_floor_union(*planes(16384, 1), 1)
    torch.cuda.synchronize()
    assert hu.LAUNCHES == before
