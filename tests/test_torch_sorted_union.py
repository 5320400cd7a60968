"""The port's plain sorted union and stable multi-key sort
(crdt_tpu_torch.ops.sorted_union) against the JAX package's, bit for bit
on seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.ops import sorted_union as jsu
from crdt_tpu_torch.ops import sorted_union as tsu

S = 2**31 - 1


@pytest.mark.parametrize("n_keys", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_sort_by_keys_matches_lax_sort(n_keys, seed):
    """Stable lexicographic sort: many ties (small key range) plus the
    int32 extremes; an arange value plane exposes any instability."""
    rng = np.random.default_rng(seed)
    n = 97
    keys = [rng.integers(-2, 3, n).astype(np.int32) for _ in range(n_keys)]
    keys[0][:4] = [S, -(2**31), S, -(2**31)]
    vals = [np.arange(n, dtype=np.int32), rng.integers(0, 2, n).astype(bool)]
    want = jax.lax.sort([jnp.asarray(x) for x in keys + vals],
                        num_keys=n_keys, is_stable=True)
    got_k, got_v = tsu._sort_by_keys([torch.from_numpy(k) for k in keys],
                                     [torch.from_numpy(v) for v in vals], n_keys)
    for w, g in zip(want, got_k + got_v):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _sorted_unique_rows(rng, n_rows, cap, universe):
    """cap-row (2-word key, 2 values) table: n_rows unique sorted keys drawn
    from a small universe (so two tables overlap), SENTINEL padded."""
    ids = np.sort(rng.choice(universe, n_rows, replace=False))
    k0 = np.full(cap, S, np.int32)
    k1 = np.full(cap, S, np.int32)
    k0[:n_rows] = ids // 4
    k1[:n_rows] = ids % 4
    v = np.zeros(cap, np.int32)
    f = np.zeros(cap, bool)
    v[:n_rows] = ids * 7 - 50   # identical key => identical value
    f[:n_rows] = ids % 3 == 0
    return (k0, k1), {"v": v, "f": f}


def _pair(rng, cap, fill_a, fill_b, universe):
    return (_sorted_unique_rows(rng, fill_a, cap, universe),
            _sorted_unique_rows(rng, fill_b, cap, universe))


def _combine_or_max(a, b):
    return {"v": torch.maximum(a["v"], b["v"]) if isinstance(a["v"], torch.Tensor)
            else jnp.maximum(a["v"], b["v"]), "f": a["f"] | b["f"]}


@pytest.mark.parametrize("out_size", [None, 16, 10])
@pytest.mark.parametrize("combine", ["keep_first", "or_max"])
def test_sorted_union_matches_jax(out_size, combine):
    rng = np.random.default_rng(7)
    (ka, va), (kb, vb) = _pair(rng, 16, 12, 11, universe=40)
    comb_j = jsu.keep_first if combine == "keep_first" else _combine_or_max
    comb_t = tsu.keep_first if combine == "keep_first" else _combine_or_max
    jk, jv, jn = jsu.sorted_union(
        tuple(map(jnp.asarray, ka)), {k: jnp.asarray(x) for k, x in va.items()},
        tuple(map(jnp.asarray, kb)), {k: jnp.asarray(x) for k, x in vb.items()},
        combine=comb_j, out_size=out_size,
    )
    tk, tv, tn = tsu.sorted_union(
        tuple(map(torch.from_numpy, ka)), {k: torch.from_numpy(x) for k, x in va.items()},
        tuple(map(torch.from_numpy, kb)), {k: torch.from_numpy(x) for k, x in vb.items()},
        combine=comb_t, out_size=out_size,
    )
    for w, g in zip(jk, tk):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    for name in ("v", "f"):
        np.testing.assert_array_equal(np.asarray(jv[name]), tv[name].numpy())
    assert int(jn) == int(tn)
    if out_size == 10:
        assert int(tn) > 10  # the overflow case is exercised


def test_sorted_union_batched_matches_vmap():
    """The port's leading batch dims equal the JAX package's vmap."""
    rng = np.random.default_rng(3)
    pairs = [_pair(rng, 8, int(rng.integers(0, 9)), int(rng.integers(0, 9)), 20)
             for _ in range(5)]

    def stacked(side, lib):
        ks = [np.stack([p[side][0][w] for p in pairs]) for w in range(2)]
        vs = {n: np.stack([p[side][1][n] for p in pairs]) for n in ("v", "f")}
        conv = jnp.asarray if lib == "jax" else torch.from_numpy
        return tuple(map(conv, ks)), {n: conv(x) for n, x in vs.items()}

    jk, jv, jn = jax.vmap(
        lambda a, b, c, d: jsu.sorted_union(a, b, c, d, out_size=8)
    )(*stacked(0, "jax"), *stacked(1, "jax"))
    tk, tv, tn = tsu.sorted_union(*stacked(0, "torch"), *stacked(1, "torch"), out_size=8)
    for w, g in zip(jk, tk):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    for name in ("v", "f"):
        np.testing.assert_array_equal(np.asarray(jv[name]), tv[name].numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
