"""The port's double-buffered stripe executor
(crdt_tpu_torch.parallel.pipeline) against the JAX package's: the twins of
tests/test_pipeline.py's ``test_run_striped_*`` and ``test_dispatch_queue_*``
cases, plus benches/bench_pipeline.py's striped sorted union at a small
shape.  Zero tolerance: pipelined == serial == JAX, stripe for stripe."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.obs.registry import MetricsRegistry as JRegistry
from crdt_tpu.parallel import pipeline as jpipe
from crdt_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from crdt_tpu_torch.ops import sorted_union as tsu
from crdt_tpu_torch.parallel import pipeline as tpipe
from crdt_tpu_torch.utils.constants import SENTINEL_PY


def _draws(seed, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 1 << 20, size=256).astype(np.int32),
             rng.integers(0, 1 << 20, size=256).astype(np.int32)) for _ in range(n)]


def test_run_striped_pipelined_matches_serial():
    """Pipelining reorders HOST work only: identical stripe operands give
    identical outputs in both schedules and in both packages, one dispatch
    a stripe, and the run's gauges and counters on the registry."""
    draws = _draws(42)
    join_j = jax.jit(jnp.maximum)
    reg_t, reg_j = TRegistry(), JRegistry()
    out_p, stats_p = tpipe.run_striped(
        6, lambda i: tuple(torch.from_numpy(x) for x in draws[i]),
        lambda i, a, b: torch.maximum(a, b), pipelined=True, registry=reg_t,
        pipeline="test")
    out_s, stats_s = tpipe.run_striped(
        6, lambda i: tuple(torch.from_numpy(x) for x in draws[i]),
        lambda i, a, b: torch.maximum(a, b), pipelined=False)
    out_j, stats_j = jpipe.run_striped(
        6, lambda i: tuple(jax.device_put(x) for x in draws[i]),
        lambda i, a, b: join_j(a, b), pipelined=True, registry=reg_j, pipeline="test")
    assert len(out_p) == len(out_s) == len(out_j) == 6
    for a, b, c in zip(out_p, out_s, out_j):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    assert stats_p["dispatches"] == stats_s["dispatches"] == stats_j["dispatches"] == 6
    assert set(stats_p) == set(stats_j)
    assert 0.0 <= stats_p["occupancy"] <= 1.0
    assert stats_s["occupancy"] == 0.0  # serial: no overlapped staging
    for reg in (reg_t, reg_j):
        assert reg.gauge_value("pipeline_occupancy", pipeline="test") is not None
        assert reg.counter_value("pipeline_stripes", pipeline="test") == 6
        assert reg.counter_value("pipeline_dispatches", pipeline="test") == 6


def test_dispatch_queue_bounded_window():
    """DispatchQueue blocks the oldest dispatch once more than ``depth`` are
    in flight, and drain() returns everything in submission order; the
    same sequence in both packages."""
    for mod in (tpipe, jpipe):
        q = mod.DispatchQueue(depth=1)
        seen = []
        for i in range(5):
            q.submit(lambda x=i: seen.append(x) or x)
            assert len(q._in_flight) <= 1
        assert q.drain() == [0, 1, 2, 3, 4] and seen == [0, 1, 2, 3, 4]
        assert q.dispatches == 5
        assert q.drain() == []  # the queue resets


def test_dispatch_queue_serial_depth_blocks_every_dispatch():
    q = tpipe.DispatchQueue(depth=0)
    q.submit(lambda: torch.ones(3))
    assert q._in_flight == [] and q.dispatches == 1
    assert [x.tolist() for x in q.drain()] == [[1.0, 1.0, 1.0]]
    assert tpipe._cuda_device((torch.ones(1), 3, {"a": [torch.zeros(2)]})) is None


def _plane(rng, cap, fill):
    ks = np.sort(rng.integers(0, 1 << 30, size=fill, dtype=np.int32))
    keys = np.full(cap, SENTINEL_PY, np.int32)
    keys[:fill] = ks
    vals = np.zeros(cap, np.int32)
    vals[:fill] = ks & 1
    return keys, vals


@pytest.mark.parametrize("pipelined", [True, False])
def test_striped_sorted_union_matches_bench_pipeline(pipelined):
    """benches/bench_pipeline.py's stripe driver (two sentinel-padded
    sorted planes a stripe, one sorted union a stripe) at 4 stripes of
    C = 64, fill C/2: the port's stripes equal the JAX driver's."""
    from benches.bench_pipeline import _stripe_driver

    want, _, _ = _stripe_driver(4, 64, 32, 7, pipelined)
    rng = np.random.default_rng(7)

    def build(i):
        ka, va = _plane(rng, 64, 32)
        kb, vb = _plane(rng, 64, 32)
        return tuple(torch.from_numpy(x) for x in (ka, va, kb, vb))

    def dispatch(i, ka, va, kb, vb):
        keys, vals, n = tsu.sorted_union((ka,), va, (kb,), vb, out_size=64)
        return keys[0], vals, n

    got, stats = tpipe.run_striped(4, build, dispatch, pipelined=pipelined,
                                   pipeline="orset_stripe")
    assert stats["dispatches"] == 4
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
