"""The single-key union, merge and bucket-local union of the port
(crdt_tpu_torch.ops.hopper_union: the plain twins the CPU runs) against the
JAX package's Pallas kernels in interpret mode and its XLA twin, bit for
bit on every plane, n_unique and bucket_max.  The CUDA kernels against the
twins are in test_torch_set_kernels.py, which runs without JAX on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.ops import pallas_union as pu
from crdt_tpu_torch.ops import hopper_union as hu

S = 2**31 - 1
C, L = 32, 128   # the Pallas kernels take lanes in tiles of 128


def _columns(rng, fill, space, c=C, lanes=L, exact=False):
    """(keys, vals) int32[c, lanes]: unique ascending keys per lane with a
    SENTINEL tail, 0/1 tombstone values, 0 on padding."""
    keys = np.full((c, lanes), S, np.int32)
    vals = np.zeros((c, lanes), np.int32)
    for j in range(lanes):
        n = fill if exact else int(rng.integers(0, fill + 1))
        keys[:n, j] = np.sort(rng.choice(space, n, replace=False))
        vals[:n, j] = rng.integers(0, 2, n)
    return keys, vals


def _case(name):
    rng = np.random.default_rng(len(name))
    if name == "random":
        return [*_columns(rng, 20, 200), *_columns(rng, 20, 200)]
    if name == "duplicate_heavy":
        # B replays A's keys with flipped tombstones, plus a few fresh keys
        ka, va = _columns(rng, 24, 48)
        kb, vb = ka.copy(), np.where(ka != S, 1 - va, 0).astype(np.int32)
        for j in range(0, L, 7):
            n = int((kb[:, j] != S).sum())
            extra = min(3, C - n)
            col = np.concatenate([kb[:n, j], 48 + rng.choice(52, extra, replace=False)])
            vcol = np.concatenate([vb[:n, j], rng.integers(0, 2, extra)])
            order = np.argsort(col, kind="stable")
            kb[:n + extra, j], vb[:n + extra, j] = col[order], vcol[order]
        return [ka, va, kb, vb]
    if name == "empty":
        ka, va = _columns(rng, 10, 100)
        return [ka, va, np.full_like(ka, S), np.zeros_like(va)]
    if name == "overflow":
        return [*_columns(rng, C, 4 * C, exact=True), *_columns(rng, C, 4 * C, exact=True)]
    raise ValueError(name)


def _jnp(planes):
    return [jnp.asarray(p) for p in planes]


def _torch(planes):
    return [torch.from_numpy(p) for p in planes]


def _assert_equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("case, out_size", [
    ("random", C), ("duplicate_heavy", C), ("empty", None), ("overflow", C),
    ("overflow", 2 * C),
])
def test_set_union_twin_matches_pallas_kernel(case, out_size):
    planes = _case(case)
    want = pu.sorted_union_columnar_fused(*_jnp(planes), out_size=out_size, interpret=True)
    got = hu.sorted_union_columnar_fused(*_torch(planes), out_size=out_size)
    _assert_equal(want, got)
    if case == "overflow":
        assert int(got[2].max()) > C


def test_unfused_union_matches_pallas_unfused_and_fused():
    planes = _case("duplicate_heavy")
    want = pu.sorted_union_columnar_unfused(*_jnp(planes), out_size=C, interpret=True)
    got = hu.sorted_union_columnar_unfused(*_torch(planes), out_size=C)
    _assert_equal(want, got)
    _assert_equal(want, hu.sorted_union_columnar(*_torch(planes), out_size=C))


def test_merge_twin_matches_pallas_merge_where_copies_agree():
    """Equal keys on both sides carry equal values (a replicated tag's
    tombstone both replicas saw): the raw merge is bit-exact."""
    rng = np.random.default_rng(4)
    ka, va = _columns(rng, 20, 40)
    kb, _ = _columns(rng, 20, 40)
    flag = (np.arange(64) * 7 % 5 < 2).astype(np.int32)   # one value per key
    planes = [ka, np.where(ka != S, flag[ka % 64], 0).astype(np.int32),
              kb, np.where(kb != S, flag[kb % 64], 0).astype(np.int32)]
    want = pu.bitonic_merge_columnar(*_jnp(planes), interpret=True)
    got = hu.bitonic_merge_columnar(*_torch(planes))
    _assert_equal(want, got)


def test_merge_order_of_equal_keys_differs_from_pallas_until_deduped():
    """The order pin: where the two copies of a key carry different values,
    the TPU's bitonic network puts either copy first, the port's rank merge
    always A's.  Keys agree, the raw value planes differ, and after the
    dedupe-and-compact OR the unions agree bit for bit."""
    rng = np.random.default_rng(3)
    planes = [*_columns(rng, C, 48), *_columns(rng, C, 48)]
    jk, jv = pu.bitonic_merge_columnar(*_jnp(planes), interpret=True)
    tk, tv = hu.bitonic_merge_columnar(*_torch(planes))
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    assert (np.asarray(jv) != tv.numpy()).any()
    # the port keeps A's copy first: at each duplicate pair, A's value first
    ka, va, kb, vb = planes
    for j in range(0, L, 17):
        a = dict(zip(ka[:, j], va[:, j]))
        b = dict(zip(kb[:, j], vb[:, j]))
        col_k, col_v = tk[:, j].numpy(), tv[:, j].numpy()
        for r in range(1, 2 * C):
            if col_k[r] == col_k[r - 1] != S:
                assert (col_v[r - 1], col_v[r]) == (a[col_k[r]], b[col_k[r]])
    for w, g in zip(pu._dedupe_and_compact(jk, jv, jnp.bitwise_or, C),
                    hu._dedupe_and_compact(tk, tv, C)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_flagged_sentinel_row_is_padding_value_included():
    """A real tag (16383, 63, 2047) packs to SENTINEL; tombstoned, it
    reaches the union as a SENTINEL key with value 1.  Both packages treat
    it as padding for keys and n_unique; the TPU kernel carries its flag
    into a padding row of the output (the flag rides a displacement word),
    the port writes SENTINEL / 0 past the unique count."""
    rng = np.random.default_rng(9)
    ka, va = _columns(rng, 10, 100)
    kb, vb = _columns(rng, 10, 100)
    for k, v in ((ka, va), (kb, vb)):
        n = (k != S).sum(axis=0)
        k[n, np.arange(L)] = S            # the tag's row, at the head of the tail
        v[n, np.arange(L)] = 1
    want = pu.sorted_union_columnar_fused(*_jnp([ka, va, kb, vb]), out_size=C, interpret=True)
    got = hu.sorted_union_columnar_fused(*_torch([ka, va, kb, vb]), out_size=C)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())
    pad = got[0].numpy() == S
    np.testing.assert_array_equal(np.asarray(want[1])[~pad], got[1].numpy()[~pad])
    assert (got[1].numpy()[pad] == 0).all()
    assert (np.asarray(want[1])[pad] != 0).any()


def _bucketed(rng, c, n_buckets, fill, key_bits):
    """Bucketed-layout planes: up to ``fill`` keys per bucket, each drawn
    from its bucket's slice of a key_bits-bit space."""
    wb = c // n_buckets
    shift = key_bits - (n_buckets.bit_length() - 1)
    keys = np.full((c, L), S, np.int32)
    vals = np.zeros((c, L), np.int32)
    for j in range(L):
        for b in range(n_buckets):
            n = int(rng.integers(0, fill + 1))
            ks = np.sort(rng.choice(1 << shift, n, replace=False)) + (b << shift)
            keys[b * wb:b * wb + n, j] = ks
            vals[b * wb:b * wb + n, j] = rng.integers(0, 2, n)
    return keys, vals


@pytest.mark.parametrize("n_buckets, fill, out_r", [
    (4, 8, None), (4, 8, 16), (4, 8, 3), (2, 16, 32), (8, 4, 0),
])
def test_bucketed_twin_matches_xla_twin(n_buckets, fill, out_r):
    rng = np.random.default_rng(n_buckets * 10 + fill)
    planes = [*_bucketed(rng, C, n_buckets, fill, 12), *_bucketed(rng, C, n_buckets, fill, 12)]
    want = pu.bucketed_union_columnar_xla(*_jnp(planes), n_buckets=n_buckets,
                                          out_bucket_rows=out_r)
    got = hu.bucketed_union_columnar(*_torch(planes), n_buckets=n_buckets,
                                     out_bucket_rows=out_r)
    _assert_equal(want, got)


def test_bucketed_twin_matches_pallas_kernel():
    rng = np.random.default_rng(12)
    planes = [*_bucketed(rng, C, 4, 8, 12), *_bucketed(rng, C, 4, 8, 12)]
    want = pu.bucketed_union_columnar(*_jnp(planes), n_buckets=4, out_bucket_rows=5,
                                      interpret=True)
    got = hu.bucketed_union_columnar(*_torch(planes), n_buckets=4, out_bucket_rows=5)
    _assert_equal(want, got)
    assert int(got[3].max()) > 5   # some bucket was cut


@pytest.mark.parametrize("n_buckets, out_r, match", [
    (3, None, "divide"), (2, 33, "2·Wb"), (4, -1, "2·Wb"),
])
def test_bucketed_wrapper_keeps_the_layout_checks(n_buckets, out_r, match):
    planes = _torch([np.full((C, 4), S, np.int32), np.zeros((C, 4), np.int32)] * 2)
    with pytest.raises(ValueError, match=match):
        hu.bucketed_union_columnar(*planes, n_buckets=n_buckets, out_bucket_rows=out_r)


def test_bucketed_twin_takes_a_non_pow2_capacity_like_jax():
    """3 buckets of 16 rows: C = 48 is no power of two, the bucket width is."""
    rng = np.random.default_rng(13)
    planes = [*_bucketed(rng, 64, 4, 6, 12), *_bucketed(rng, 64, 4, 6, 12)]
    planes = [p[:48] for p in planes]
    want = pu.bucketed_union_columnar_xla(*_jnp(planes), n_buckets=3)
    _assert_equal(want, hu.bucketed_union_columnar(*_torch(planes), n_buckets=3))


def test_bucketed_wrapper_refuses_non_pow2_bucket_width():
    planes = _torch([np.full((24, 4), S, np.int32), np.zeros((24, 4), np.int32)] * 2)
    with pytest.raises(ValueError, match="power of two"):
        hu.bucketed_union_columnar(*planes, n_buckets=2)


@pytest.mark.parametrize("fn", ["set_union", "merge", "bucketed_union"])
def test_non_cpu_planes_never_reach_the_twins(fn, monkeypatch):
    def twin_called(*_a, **_k):
        raise AssertionError("a plain twin was reached")

    for twin in ("_set_union_plain", "_merge_plain", "_bucketed_union_plain"):
        monkeypatch.setattr(hu, twin, twin_called)
    planes = [torch.full((8, 4), S, dtype=torch.int32, device="meta")] * 4
    call = {"set_union": lambda: hu.sorted_union_columnar_fused(*planes),
            "merge": lambda: hu.bitonic_merge_columnar(*planes),
            "bucketed_union": lambda: hu.bucketed_union_columnar(*planes, n_buckets=2)}[fn]
    before = dict(hu.LAUNCHES)
    with pytest.raises(ValueError, match=f"no {fn} kernel"):
        call()
    assert hu.LAUNCHES == before
