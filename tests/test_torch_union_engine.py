"""The port's union engines (crdt_tpu_torch.ops.union_engine) against the
JAX package's (crdt_tpu.ops.union_engine): the planner, the tallies, the
bitmap and bucketed layout conversions, the three engines and the
dispatcher, bit for bit on seeded inputs.  The JAX kernels run in interpret
mode; lanes the Pallas tile does not divide go through ``dispatch_union``,
which pads them on the JAX side."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.ops import union_engine as jue
from crdt_tpu.obs.registry import MetricsRegistry
from crdt_tpu_torch.ops import union_engine as tue

S = 2**31 - 1
C, L = 64, 128
KEY_BITS = 12
UNIVERSE = 1 << KEY_BITS


def _columns(rng, fill, space=UNIVERSE, lanes=L, exact=False):
    keys = np.full((C, lanes), S, np.int32)
    vals = np.zeros((C, lanes), np.int32)
    for j in range(lanes):
        n = fill if exact else int(rng.integers(0, fill + 1))
        keys[:n, j] = np.sort(rng.choice(space, n, replace=False))
        vals[:n, j] = rng.integers(0, 2, n)
    return keys, vals


def _sentinel_edge(rng):
    """Keys 0 and UNIVERSE - 1 (top bucket, bit 31 of the top word) in
    every lane of A."""
    keys = np.full((C, L), S, np.int32)
    vals = np.zeros((C, L), np.int32)
    for j in range(L):
        mids = rng.choice(np.arange(1, UNIVERSE - 1), 18, replace=False)
        keys[:20, j] = np.sort(np.concatenate([[0, UNIVERSE - 1], mids]))
        vals[:20, j] = rng.integers(0, 2, 20)
    return keys, vals


def _pair(case):
    rng = np.random.default_rng(len(case))
    if case == "random":
        return [*_columns(rng, 20), *_columns(rng, 20)]
    if case == "duplicate_heavy":
        ka, va = _columns(rng, 30, space=64)
        kb, vb = _columns(rng, 30, space=64)
        return [ka, va, kb, vb]
    if case == "empty":
        ka, va = _columns(rng, 10)
        return [np.full_like(ka, S), np.zeros_like(va), ka, va]
    if case == "sentinel_edge":
        return [*_sentinel_edge(rng), *_columns(rng, 20)]
    if case == "capacity_boundary":
        return [*_columns(rng, C, exact=True), *_columns(rng, C, exact=True)]
    raise ValueError(case)


def _j(planes):
    return [jnp.asarray(p) for p in planes]


def _t(planes):
    return [torch.from_numpy(np.ascontiguousarray(p)) for p in planes]


def _assert_equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


# ---- planner and tallies ----------------------------------------------------


def test_plan_union_matches_over_a_grid():
    for cap in (16, 32, 63, 64, 96, 128, 1024):
        for universe in (None, 32, 1000, 32 * cap, 32 * cap + 1, 1 << 20):
            for key_bits in (12, 31, 40):
                want = jue.plan_union(cap, universe=universe, key_bits=key_bits)
                got = tue.plan_union(cap, universe=universe, key_bits=key_bits)
                assert dataclasses_equal(want, got), (cap, universe, key_bits)
    assert [tue.bitmap_words(u) for u in (0, 1, 32, 33, 4096)] == \
        [jue.bitmap_words(u) for u in (0, 1, 32, 33, 4096)]


def dataclasses_equal(a, b):
    return all(getattr(a, f) == getattr(b, f)
               for f in ("path", "reason", "universe", "n_buckets", "key_bits"))


def test_tallies_count_paths_and_truncations():
    tue.reset_tallies()
    tue.record_union_path("sort")
    tue.record_union_path("bucket", 3)
    tue.record_truncation()
    tue.record_truncation(2)
    assert tue.union_path_counts() == {"sort": 1, "bucket": 3}
    assert tue.truncation_count() == 3
    tue.reset_tallies()
    assert tue.union_path_counts() == {} and tue.truncation_count() == 0


def test_record_union_path_feeds_a_registry_once():
    """The duck-typed registry (here the JAX package's MetricsRegistry)
    gets the counter directly and its sampled gauge advances with it."""
    tue.reset_tallies()
    reg = MetricsRegistry()
    tue.record_union_path("bucket", registry=reg)
    tue.record_union_path("bucket", 2, registry=reg)
    assert reg.counter_value("union_path", path="bucket") == 3
    assert reg.gauge_value("union_path_sampled", path="bucket") == 3
    assert tue.union_path_counts() == {"bucket": 3}


def test_tallies_are_thread_safe():
    import threading
    import sys

    tue.reset_tallies()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [tue.record_union_path("sort")
                                                    for _ in range(2000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert tue.union_path_counts() == {"sort": 16000}


# ---- bitmap layout ----------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "sentinel_edge", "capacity_boundary"])
def test_bitmap_conversions_match(case):
    ka, va, kb, vb = _pair(case)
    want = jue.sorted_to_bitmap(*_j([ka, va]), UNIVERSE)
    got = tue.sorted_to_bitmap(*_t([ka, va]), UNIVERSE)
    _assert_equal(want, got)
    wb = jue.sorted_to_bitmap(*_j([kb, vb]), UNIVERSE)
    gb = tue.sorted_to_bitmap(*_t([kb, vb]), UNIVERSE)
    _assert_equal(jue.bitmap_union(*want, *wb), tue.bitmap_union(*got, *gb))
    p, r = tue.bitmap_union(*got, *gb)
    _assert_equal([jue.bitmap_count(jnp.asarray(p.numpy()))], [tue.bitmap_count(p)])
    for out in (C, 10, 2 * C):
        _assert_equal(jue.bitmap_to_sorted(*_j([p.numpy(), r.numpy()]), out),
                      tue.bitmap_to_sorted(p, r, out))


def test_bitmap_top_bit_and_negative_words():
    """Bit 31 packs as a negative int32; the popcount and the extraction
    must still count and return it."""
    ks = np.full((C, 4), S, np.int32)
    ks[0], ks[1] = 31, 63
    vs = np.zeros((C, 4), np.int32)
    vs[0] = 1
    p, r = tue.sorted_to_bitmap(*_t([ks, vs]), 64)
    assert int(p[0, 0]) < 0
    _assert_equal(jue.sorted_to_bitmap(*_j([ks, vs]), 64), (p, r))
    words = np.array([[-1, -2**31, 0x7FFFFFFF, -12345, 1]], np.int32).T
    _assert_equal([jue.bitmap_count(jnp.asarray(words))],
                  [tue.bitmap_count(torch.from_numpy(words))])
    _assert_equal(jue.bitmap_to_sorted(jnp.asarray(words), jnp.asarray(words), 2 * C),
                  tue.bitmap_to_sorted(torch.from_numpy(words), torch.from_numpy(words), 2 * C))


def test_bitmap_universe_smaller_than_out_size_pads():
    rng = np.random.default_rng(14)
    planes = [*_columns(rng, 10, space=32), *_columns(rng, 10, space=32)]
    want = jue.engine_bitmap(*_j(planes), C, universe=32)
    got = tue.engine_bitmap(*_t(planes), C, universe=32)
    assert got[0].shape == (C, L)
    _assert_equal(want, got)


def test_bitmap_rows_past_the_universe_follow_jax_drop_rules():
    keys = np.full((C, 2), S, np.int32)
    keys[:3, 0] = [3, 100, 5000]         # 5000 lies past a 64-tag universe
    vals = np.ones((C, 2), np.int32)
    _assert_equal(jue.sorted_to_bitmap(*_j([keys, vals]), 64),
                  tue.sorted_to_bitmap(*_t([keys, vals]), 64))


# ---- bucketed layout --------------------------------------------------------


@pytest.mark.parametrize("n_buckets, fill", [(8, 12), (4, 20), (64, 40)])
def test_bucketed_conversions_match(n_buckets, fill):
    rng = np.random.default_rng(n_buckets)
    ka, va = _columns(rng, fill)
    want = jue.sorted_to_bucketed(*_j([ka, va]), n_buckets, KEY_BITS)
    got = tue.sorted_to_bucketed(*_t([ka, va]), n_buckets, KEY_BITS)
    _assert_equal(want, got)
    _assert_equal(jue.bucketed_to_sorted(*want[:2]), tue.bucketed_to_sorted(*got[:2]))
    if n_buckets == 64:
        assert int(got[2].max()) > 0     # one-row buckets overflow: rows dropped


def test_bucket_shift_and_layout_errors():
    assert tue.bucket_shift(64) == jue.bucket_shift(64) == 25
    assert tue.bucket_shift(8, 12) == jue.bucket_shift(8, 12)
    with pytest.raises(ValueError, match="power of 2"):
        tue.bucket_shift(6)
    with pytest.raises(ValueError, match="exceed"):
        tue.bucket_shift(1 << 5, 4)
    with pytest.raises(ValueError, match="divide"):
        tue.sorted_to_bucketed(*_t([np.full((C, 2), S, np.int32)] * 2), 3)


# ---- engines and the dispatcher ---------------------------------------------


@pytest.mark.parametrize("case", ["random", "duplicate_heavy", "empty",
                                  "sentinel_edge", "capacity_boundary"])
def test_engines_match_jax_and_each_other(case):
    planes = _pair(case)
    want = jue.engine_sort(*_j(planes), C, interpret=True)
    got = {
        "sort": tue.engine_sort(*_t(planes), C),
        "bucket": tue.engine_bucket(*_t(planes), C, key_bits=KEY_BITS),
        "bitmap": tue.engine_bitmap(*_t(planes), C, universe=UNIVERSE),
    }
    for out in got.values():
        _assert_equal(want, out)
    if case == "capacity_boundary":
        assert int(got["sort"][2].max()) > C


def test_engine_bucket_matches_jax_kernel_path():
    planes = _pair("random")
    want = jue.engine_bucket(*_j(planes), C, interpret=True, use_kernel=True,
                             key_bits=KEY_BITS)
    _assert_equal(want, tue.engine_bucket(*_t(planes), C, key_bits=KEY_BITS))


def test_bucket_overflow_falls_back_to_sort_and_tallies():
    """At C=64 the default plan has 4 buckets of 16 rows over 31-bit keys;
    20 keys < 4096 all land in bucket 0, so the conversion drops rows and
    the engine serves the sort path — and says so on the tally."""
    rng = np.random.default_rng(15)
    planes = [*_columns(rng, 20, exact=True), *_columns(rng, 20, exact=True)]
    jue.reset_tallies()
    want = jue.dispatch_union(*_j(planes), C, engine="bucket", interpret=True)
    tue.reset_tallies()
    got = tue.dispatch_union(*_t(planes), C, engine="bucket")
    assert got[3] == want[3] == "bucket"
    _assert_equal(want[:3], got[:3])
    assert tue.union_path_counts() == jue.union_path_counts() == {
        "bucket": 1, "bucket_fallback_sort": 1}


@pytest.mark.parametrize("engine, universe, lanes", [
    ("auto", 1024, 130), ("auto", None, 5), ("sort", None, 130), ("bitmap", UNIVERSE, 3),
])
def test_dispatch_matches_on_ragged_lanes(engine, universe, lanes):
    rng = np.random.default_rng(lanes)
    space = universe or UNIVERSE
    planes = [*_columns(rng, 8, space, lanes), *_columns(rng, 8, space, lanes)]
    jue.reset_tallies()
    want = jue.dispatch_union(*_j(planes), C, engine=engine, universe=universe,
                              interpret=True)
    tue.reset_tallies()
    got = tue.dispatch_union(*_t(planes), C, engine=engine, universe=universe)
    assert got[3] == want[3]
    _assert_equal(want[:3], got[:3])
    assert tue.union_path_counts() == jue.union_path_counts()


def test_dispatch_validates_pinned_engines():
    planes = _t([np.full((C, 4), S, np.int32), np.zeros((C, 4), np.int32)] * 2)
    with pytest.raises(ValueError, match="universe"):
        tue.dispatch_union(*planes, C, engine="bitmap")
    with pytest.raises(KeyError, match="unknown union engine"):
        tue.dispatch_union(*planes, C, engine="radix")
    for cap in (96, 32):
        p = _t([np.full((cap, 4), S, np.int32), np.zeros((cap, 4), np.int32)] * 2)
        with pytest.raises(ValueError, match="power-of-two"):
            tue.dispatch_union(*p, cap, engine="bucket")
    with pytest.raises(ValueError, match="universe"):
        tue.engine_bitmap(*planes, C)
    assert tue.get_engine("sort") is tue.engine_sort
    assert sorted(tue.ENGINES) == sorted(jue.ENGINES)
