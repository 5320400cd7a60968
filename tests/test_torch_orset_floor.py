"""The OR-Set union floors of the port (crdt_tpu_torch.ops.orset_floor: the
plain twins the CPU runs) against the JAX package's Pallas floors
(benches/orset_floor.py) in interpret mode and against a closed form in
numpy, bit for bit on keys, values and nu.  The CUDA kernels against the
twins are in test_torch_orset_floor_cuda.py, which runs without JAX on a
card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benches import orset_floor as jof
from crdt_tpu_torch.ops import hopper_union as hu
from crdt_tpu_torch.ops import orset_floor as of

S = 2**31 - 1
U32 = np.uint64(0xFFFFFFFF)


def _orset_draw(rng, c, lanes):
    """benches/orset_floor.py's draw: each column sorted uniform [0, 2^30),
    the first C/2 rows real and the rest SENTINEL, vals = the draw & 1."""
    kk = np.sort(rng.integers(0, 1 << 30, (c, lanes)), axis=0).astype(np.int32)
    keys = np.where(np.arange(c)[:, None] < c // 2, kk, S).astype(np.int32)
    return keys, (kk & 1).astype(np.int32)


def _full_range_draw(rng, c, lanes):
    """Full-range int32 keys with a fifth of the rows SENTINEL and values
    past 2^15: the sums wrap and the ``<< 16`` drops bits."""
    keys = rng.integers(-2**31, 2**31, (c, lanes)).astype(np.int32)
    keys[rng.random((c, lanes)) < 0.2] = S
    return keys, rng.integers(-2**31, 2**31, (c, lanes)).astype(np.int32)


def _planes(draw, c, lanes, seed):
    rng = np.random.default_rng(seed)
    make = _orset_draw if draw == "orset" else _full_range_draw
    return [*make(rng, c, lanes), *make(rng, c, lanes)]


def _jnp(planes):
    return [jnp.asarray(p) for p in planes]


def _torch(planes):
    return [torch.from_numpy(p) for p in planes]


def _assert_equal(want, got):
    assert len(want) == len(got) == 3
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _closed_form(ka, va, kb, vb, seg, out_seg, value_stages="widest_first"):
    """The floor in uint64 numpy held to 32 bits: the key butterflies run
    narrowest first (they commute), the value butterflies in the order
    given, the scans as cumulative sums and ORs."""
    c, lanes = ka.shape
    nb, n, seg2 = c // seg, 2 * c, 2 * seg

    def u(x):
        return x.astype(np.int64).astype(np.uint64) & U32

    def interleave(a, b_rev):
        return np.concatenate([a.reshape(nb, seg, lanes), b_rev.reshape(nb, seg, lanes)],
                              axis=1).reshape(n, lanes)

    def rev(b):
        return b.reshape(nb, seg, lanes)[:, ::-1].reshape(c, lanes)

    keys, vals = interleave(u(ka), rev(u(kb))), interleave(u(va), rev(u(vb)))
    strides = [seg >> i for i in range(seg.bit_length())]  # seg .. 1
    for s in reversed(strides):
        r = keys.reshape(-1, 2, s, lanes)
        keys = np.stack([(r[:, 0] + r[:, 1]) & U32, (r[:, 0] - r[:, 1]) & U32],
                        axis=1).reshape(n, lanes)
    for s in (strides if value_stages == "widest_first" else reversed(strides)):
        r = vals.reshape(-1, 2, s, lanes)
        vals = np.stack([r[:, 0] | r[:, 1], r[:, 0] ^ r[:, 1]], axis=1).reshape(n, lanes)
    zero = np.zeros((1, lanes), np.uint64)
    keys = (keys + np.concatenate([zero + np.uint64(S), keys[:-1]])) & U32
    vals = vals | np.concatenate([vals[1:], zero])
    keys = keys ^ np.concatenate([keys[1:], zero])
    p = np.cumsum((keys & np.uint64(1)).reshape(nb, seg2, lanes), axis=1).reshape(n, lanes)
    disp = (p | (vals << np.uint64(16))) & U32

    def suffix(x, op):
        r = x.reshape(nb, seg2, lanes)[:, ::-1]
        return op.accumulate(r, axis=1)[:, ::-1].reshape(n, lanes)

    keys = suffix(keys, np.add) & U32
    disp = suffix(disp, np.bitwise_or)

    def head(x):
        return x.reshape(nb, seg2, lanes)[:, :out_seg].reshape(nb * out_seg, lanes)

    as_i32 = lambda x: x.astype(np.uint32).view(np.int32)  # noqa: E731
    return as_i32(head(keys)), as_i32(head(disp)) >> 16, as_i32(p[n - 1:n])


@pytest.mark.parametrize("draw, lanes", [("orset", 128), ("full_range", 256)])
@pytest.mark.parametrize("c", [8, 16, 64])
@pytest.mark.parametrize("half", [False, True], ids=["out=C", "out=C/2"])
def test_floor_twin_matches_pallas_floor(draw, lanes, c, half):
    planes = _planes(draw, c, lanes, seed=c + lanes + half)
    out = c // 2 if half else c
    want = jof.floor_union(*_jnp(planes), out_size=out, interpret=True)
    got = of.floor_union(*_torch(planes), out_size=out)
    _assert_equal(want, got)
    _assert_equal(_closed_form(*planes, c, out), got)


@pytest.mark.parametrize("draw, lanes", [("orset", 128), ("full_range", 256)])
@pytest.mark.parametrize("c", [8, 16, 64])
@pytest.mark.parametrize("n_buckets", [2, 4])
def test_bucketed_floor_twin_matches_pallas_floor(draw, lanes, c, n_buckets):
    planes = _planes(draw, c, lanes, seed=3 * c + lanes + n_buckets)
    want = jof.bucketed_floor_union(*_jnp(planes), n_buckets, interpret=True)
    got = of.bucketed_floor_union(*_torch(planes), n_buckets)
    _assert_equal(want, got)
    _assert_equal(_closed_form(*planes, c // n_buckets, c // n_buckets), got)


@pytest.mark.parametrize("bucketed", [False, True], ids=["floor", "bucketed"])
def test_ragged_lanes_match_jax_padded_to_the_tile(bucketed):
    """Lanes are independent: the port on 200 lanes equals the Pallas floor
    on the same lanes padded to 256 (its tile is 128 lanes)."""
    c, lanes = 16, 200
    planes = _planes("full_range", c, lanes, seed=7)
    padded = [np.pad(p, ((0, 0), (0, 256 - lanes)), constant_values=S) for p in planes]
    if bucketed:
        want = jof.bucketed_floor_union(*_jnp(padded), 4, interpret=True)
        got = of.bucketed_floor_union(*_torch(planes), 4)
    else:
        want = jof.floor_union(*_jnp(padded), out_size=c, interpret=True)
        got = of.floor_union(*_torch(planes), out_size=c)
    _assert_equal([np.asarray(w)[:, :lanes] for w in want], got)


@pytest.mark.parametrize("bucketed", [False, True], ids=["floor", "bucketed"])
def test_value_stages_do_not_commute(bucketed):
    """The value butterflies (a | b, a ^ b) must run from the widest stride
    down: run narrowest first, the values differ (the keys do not: their
    (a + b, a - b) stages commute).  Sparse values keep the suffix OR from
    filling every bit, so the order shows in the output."""
    c, lanes = 64, 128
    rng = np.random.default_rng(0)
    ka, kb = _orset_draw(rng, c, lanes)[0], _orset_draw(rng, c, lanes)[0]
    va, vb = (((rng.random((c, lanes)) < 0.1) * rng.integers(1, 1 << 15, (c, lanes)))
              .astype(np.int32) for _ in range(2))
    planes = [ka, va, kb, vb]
    seg = c // 4 if bucketed else c
    if bucketed:
        want = jof.bucketed_floor_union(*_jnp(planes), 4, interpret=True)
        got = of.bucketed_floor_union(*_torch(planes), 4)
    else:
        want = jof.floor_union(*_jnp(planes), out_size=c, interpret=True)
        got = of.floor_union(*_torch(planes), out_size=c)
    _assert_equal(want, got)
    _assert_equal(_closed_form(*planes, seg, seg), got)
    keys, vals, nu = _closed_form(*planes, seg, seg, value_stages="narrowest_first")
    np.testing.assert_array_equal(keys, got[0].numpy())
    assert not np.array_equal(vals, got[1].numpy())


def test_floor_keeps_the_first_out_size_rows():
    c = 16
    planes = _torch(_planes("orset", c, 8, seed=5))
    for out in (0, 1, c, 2 * c):
        ko, vo, nu = of.floor_union(*planes, out_size=out)
        assert ko.shape == vo.shape == (out, 8) and nu.shape == (1, 8)
    full = of.floor_union(*planes, out_size=2 * c)
    assert torch.equal(of.floor_union(*planes, out_size=c // 2)[0], full[0][:c // 2])


def _bad(**kw):
    base = dict(c=8, lanes=4, dtype=torch.int32)
    base.update(kw)
    return [torch.zeros((base["c"], base["lanes"]), dtype=base["dtype"]) for _ in range(4)]


@pytest.mark.parametrize("planes, kw, match", [
    (_bad(c=12), {}, "power of two"),
    (_bad(dtype=torch.int64), {}, "int32"),
    ([torch.zeros((8, 4, 2), dtype=torch.int32)] * 4, {}, r"\(C, L\)"),
    (_bad()[:3] + [torch.zeros((8, 5), dtype=torch.int32)], {}, "shape"),
    (_bad()[:3] + [torch.zeros((4, 8), dtype=torch.int32).T], {}, "contiguous"),
    (_bad(), {"out_size": 17}, "out_size"),
    (_bad(), {"out_size": -1}, "out_size"),
    (_bad(), {"n_buckets": 3}, "divide"),
    (_bad(), {"n_buckets": 0}, "divide"),
], ids=["c=12", "int64", "3-d", "shape", "strided", "out>2C", "out<0", "B=3", "B=0"])
def test_bad_shapes_are_refused(planes, kw, match):
    before = dict(hu.LAUNCHES)
    with pytest.raises((ValueError, TypeError), match=match):
        if "n_buckets" in kw:
            of.bucketed_floor_union(*planes, kw["n_buckets"])
        else:
            of.floor_union(*planes, out_size=kw.get("out_size", 8))
    assert hu.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda p: of.floor_union(*p, out_size=8),
    lambda p: of.bucketed_floor_union(*p, 2),
], ids=["floor", "bucketed"])
def test_planes_off_the_cpu_never_reach_the_twin(call, monkeypatch):
    """Planes on a device with no kernel raise; the twin is not reached and
    no launch is counted."""
    def twin_called(*_a, **_k):
        raise AssertionError("the plain twin was reached")

    monkeypatch.setattr(of, "_floor_plain", twin_called)
    planes = [torch.full((8, 4), S, dtype=torch.int32, device="meta")] * 4
    before = dict(hu.LAUNCHES)
    with pytest.raises(ValueError, match="no [a-z_]*floor_union kernel"):
        call(planes)
    assert hu.LAUNCHES == before
