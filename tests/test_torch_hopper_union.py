"""The fused lexN union (crdt_tpu_torch.ops.hopper_union): its plain twin
against the JAX Pallas kernel in interpret mode, bit for bit on every plane
and n_unique.  The CUDA kernel against the twin is in
test_torch_hopper_kernel.py, which runs without JAX on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.ops import pallas_union as pu
from crdt_tpu_torch.ops import hopper_union as hu

S = 2**31 - 1


def _lanes(rng, c, lanes, pool, fraction=0.4):
    """(hi, lo, val, pay) planes: each lane a seeded subset of the pool,
    sorted by (hi, lo), at most c rows, SENTINEL/0 padded."""
    g = len(pool[0])
    planes = [np.full((c, lanes), S, np.int32), np.full((c, lanes), S, np.int32),
              np.zeros((c, lanes), np.int32), np.zeros((c, lanes), np.int32)]
    order = np.lexsort([pool[1], pool[0]])
    for j in range(lanes):
        rows = order[rng.random(g)[order] < fraction][:c]
        for p in range(4):
            planes[p][: len(rows), j] = pool[p][rows]
    return planes


def _pool(rng, g):
    ids = rng.choice(10 * g, g, replace=False)
    return [
        (ids // 4).astype(np.int32),                      # ts with collisions
        ids.astype(np.int32),                             # packed identity
        rng.integers(-20, 20, g).astype(np.int32),
        (rng.integers(0, 1000, g) | (rng.integers(0, 2, g) << 31)).astype(np.int32),
    ]


def _jax_lex2(a, b, out_size):
    """The Pallas kernel in interpret mode; lanes padded to its 128 tile."""
    lanes = a[0].shape[1]
    pad = -lanes % pu.LANES

    def j(x, fill):
        return jnp.asarray(np.pad(x, ((0, 0), (0, pad)), constant_values=fill))

    (hi, lo), (val, pay), nu = pu.sorted_union_columnar_fused_lex2(
        (j(a[0], S), j(a[1], S)), (j(a[2], 0), j(a[3], 0)),
        (j(b[0], S), j(b[1], S)), (j(b[2], 0), j(b[3], 0)),
        out_size=out_size, interpret=True,
    )
    return [np.asarray(x)[:, :lanes] for x in (hi, lo, val, pay)], np.asarray(nu)[:lanes]


def _torch_lex2(a, b, out_size, device="cpu"):
    t = [torch.from_numpy(x).to(device) for x in a + b]
    (hi, lo), (val, pay), nu = hu.sorted_union_columnar_fused_lex2(
        (t[0], t[1]), (t[2], t[3]), (t[4], t[5]), (t[6], t[7]), out_size=out_size
    )
    return [x.cpu().numpy() for x in (hi, lo, val, pay)], nu.cpu().numpy()


@pytest.mark.parametrize("c", [8, 64])
@pytest.mark.parametrize("lanes", [1, 130])
@pytest.mark.parametrize("case", ["mid_gossip", "overflow", "or_rule"])
def test_plain_twin_matches_pallas_kernel(c, lanes, case):
    rng = np.random.default_rng(c * 1000 + lanes)
    # overflow: a pool of 4C ops at 60% per side pushes n_unique past C
    pool = _pool(rng, 4 * c if case == "overflow" else c)
    fraction = 0.6 if case == "overflow" else 0.4
    a = _lanes(rng, c, lanes, pool, fraction)
    b = _lanes(rng, c, lanes, pool, fraction)
    if case == "or_rule":
        # duplicate copies carry different value bits: the kept copy must
        # hold a | b (OR-combine-then-keep-first), not either copy alone
        flip = (rng.integers(0, 2, b[2].shape) * 8).astype(np.int32)
        b[2] = np.where(b[0] != S, b[2] ^ flip, 0).astype(np.int32)
    want, want_nu = _jax_lex2(a, b, c)
    got, got_nu = _torch_lex2(a, b, c)
    for w, g, name in zip(want, got, ("hi", "lo", "val", "pay")):
        np.testing.assert_array_equal(w, g, err_msg=name)
    np.testing.assert_array_equal(want_nu, got_nu)
    if case == "overflow":
        assert got_nu.max() > c


def test_plain_twin_untruncated_matches_pallas_kernel():
    rng = np.random.default_rng(5)
    pool = _pool(rng, 16)
    a, b = _lanes(rng, 8, 3, pool), _lanes(rng, 8, 3, pool)
    want, want_nu = _jax_lex2(a, b, None)
    got, got_nu = _torch_lex2(a, b, None)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    np.testing.assert_array_equal(want_nu, got_nu)


def _planes(c=8, lanes=4):
    return [torch.full((c, lanes), S, dtype=torch.int32) for _ in range(4)]


@pytest.mark.parametrize("bad, match", [
    ("non_pow2", "power of two"),
    ("dtype", "int32"),
    ("shape", "shape"),
    ("strided", "contiguous"),
    ("out_size", "out_size"),
])
def test_wrapper_rejects_bad_planes(bad, match):
    a, b = _planes(), _planes()
    out_size = None
    if bad == "non_pow2":
        a = [torch.full((6, 4), S, dtype=torch.int32) for _ in range(4)]
        b = [x.clone() for x in a]
    elif bad == "dtype":
        b[3] = b[3].to(torch.int64)
    elif bad == "shape":
        b[1] = torch.full((8, 5), S, dtype=torch.int32)
    elif bad == "strided":
        b[2] = torch.zeros((8, 8), dtype=torch.int32)[:, ::2]
    elif bad == "out_size":
        out_size = 17
    with pytest.raises((ValueError, TypeError), match=match):
        hu.sorted_union_columnar_fused_lex2(
            a[:2], a[2:], b[:2], b[2:], out_size=out_size)
