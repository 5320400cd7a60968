"""The frozen generators and the plain reference agree with each other,
and with a plain fold written out key by key, at tiny sizes; the
rooflines' byte counts hold PERF.md's bounds."""
import numpy as np
import pytest
import torch

from portbench import gen, reference, roofline

KV = dict(delta_min=-20, delta_max=-11, non_numeric=0.1, writes_per_ms=3)


def fold(pool, held_row, n_keys):
    """One replica's view, op by op from the newest (main.go:76-98): the
    newest op seeds the key; older numeric ops add while the newest is
    numeric.  {key: ("sum", total) or ("raw", payload id)}."""
    state = {}
    for i in reversed(np.nonzero(held_row)[0]):
        k, num, val = int(pool.ops["key"][i]), bool(pool.ops["is_num"][i]), int(pool.ops["val"][i])
        if k not in state:
            state[k] = [int(pool.ops["payload"][i]), (val, 1) if num else None]
        elif state[k][1] is not None and num:
            state[k][1] = (state[k][1][0] + val, state[k][1][1] + 1)
    return {k: ("sum", acc[0]) if acc and acc[1] > 1 else ("raw", p)
            for k, (p, acc) in state.items()}


def as_fold(view, lane):
    present, summed, value = (x[lane] for x in reference.decoded(view))
    return {k: ("sum" if bool(summed[k]) else "raw", int(value[k]))
            for k in range(len(present)) if bool(present[k])}


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 12345678901234])
def test_kv_views_equal_the_op_by_op_fold(seed):
    pool = gen.reference_writes(120, 16, gen.subseed(seed, 0), **KV)
    ident = np.stack([pool.ops[f] for f in ("ts", "rid", "seq")]).T
    assert (np.diff(ident, axis=0) != 0).any(1).all()
    g = gen.device_generator("cpu", gen.subseed(seed, 1))
    held = gen.draw_held(16, len(pool), 0.4, g)
    alive = torch.ones(16, dtype=torch.bool)
    alive[3] = False
    for peers in (gen.random_peers(g, 16) for _ in range(3)):
        assert not bool((peers == torch.arange(16)).any())
        held = reference.pull_round(held, peers, alive, 128)
    final, n = reference.barrier(held, alive, 128)
    assert n == int(held[alive].any(0).sum())
    view = reference.views(final, pool, len(gen.ALPHABET))
    for lane in range(16):
        assert as_fold(view, lane) == fold(pool, final[lane].numpy(), len(gen.ALPHABET))
    assert torch.equal(final[3], held[3])


def test_kv_logs_keep_the_first_held_rows_in_pool_order():
    pool = gen.reference_writes(40, 8, 3, **KV)
    held = gen.draw_held(8, len(pool), 0.7, gen.device_generator("cpu", 4))
    logs, kept = gen.logs_from_held(pool, held, 16)
    assert torch.equal(kept, reference.cap(held, 16))
    for lane in range(8):
        idx = np.nonzero(kept[lane].numpy())[0]
        n = len(idx)
        assert n == min(16, int(held[lane].sum()))
        for f in gen.LOG_FIELDS:
            assert np.array_equal(logs[f][lane, :n].numpy(), pool.ops[f][idx])
        assert (logs["ts"][lane, n:] == gen.SENTINEL).all()
    assert reference.log_lanes_wrong(logs, kept, pool, 16) == 0
    logs["val"][5, 0] += 1
    assert reference.log_lanes_wrong(logs, kept, pool, 16) == 1


def test_orset_rows_equal_the_reference_join_with_an_empty_side():
    pool = gen.set_pool(7, elems=64, writers=8, tags_per_writer=8, removable=0.25)
    assert pool.packed().tolist() == sorted(pool.packed().tolist())
    kw = dict(hold=0.4, seen_remove=0.5, device="cpu")
    rows = gen.set_swarm(pool, 70, 32, 11, **kw)
    (_, h, sn), = list(gen.set_draws(pool, 70, 32, 11, **kw))
    empty = torch.zeros_like(h)
    out = reference.set_join_block(h, sn, empty, empty, torch.as_tensor(pool.packed()),
                                   torch.as_tensor(pool.elem).long(), 32, 64)
    packed = torch.as_tensor(pool.packed())
    for lane in range(70):
        idx = np.nonzero(h[lane].numpy())[0]
        assert rows["elem"][lane, :len(idx)].tolist() == pool.elem[idx].tolist()
        assert out["keys"][lane, :len(idx)].tolist() == packed[idx].tolist()
        removed = out["removed"][lane, :len(idx)].bool()
        assert removed.tolist() == rows["removed"][lane, :len(idx)].tolist()
        live = {int(pool.elem[i]) for i in idx if not bool(sn[lane, i])}
        assert set(out["member"][lane].nonzero().flatten().tolist()) == live
    assert torch.equal(out["n_unique"], h.sum(1))


def test_orset_draws_repeat_from_the_seed():
    pool = gen.set_pool(1, elems=64, writers=8, tags_per_writer=8, removable=0.25)
    kw = dict(hold=0.4, seen_remove=0.5, device="cpu")
    a = list(gen.set_draws(pool, 20, 32, 99, **kw))
    b = list(gen.set_draws(pool, 20, 32, 99, **kw))
    assert all(torch.equal(x[1], y[1]) and torch.equal(x[2], y[2]) for x, y in zip(a, b))


def test_relabelled_pools_keep_their_element_multiplicities():
    pool = gen.set_pool(3, elems=64, writers=8, tags_per_writer=8, removable=0.25)
    a, b = (gen.relabel_elems(pool, 64, s) for s in (5, 6))
    count = lambda p: sorted(np.bincount(p.elem, minlength=64))
    assert count(a) == count(b) == count(pool)
    assert not np.array_equal(a.elem, b.elem)
    for p in (a, b):
        assert np.all(np.diff(p.packed().astype(np.int64)) > 0)
        assert p.removable.sum() == pool.removable.sum()
    # a tag keeps its writer, sequence number and removability
    tags = lambda p: sorted(zip(p.rid.tolist(), p.seq.tolist(), p.removable.tolist()))
    assert tags(a) == tags(pool)


def test_roofline_bytes_hold_the_kernel_table_bounds():
    assert round(roofline.bound_s(roofline.gossip_round_bytes(1024, 10_240)) * 1e3, 4) == 0.1503
    assert round(roofline.bound_s(roofline.set_join_bytes(1024, 1 << 20)) * 1e3, 4) == 7.6937


def test_trace_reduction_of_a_small_chrome_trace():
    """Spans, launches matched to device work by correlation, busy time and
    the idle gaps by the innermost span open when each began (times in
    us)."""
    from portbench.traces import Trace

    def ev(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    trace = Trace([
        ev("user_annotation", "outer", 0, 100),
        ev("user_annotation", "inner", 10, 25),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 2, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 150, 2, corr=3),
        ev("kernel", "k1", 20, 10, corr=1),
        ev("kernel", "k2", 60, 20, corr=2),
        ev("kernel", "k1", 200, 5, corr=3),
        ev("gpu_memset", "fill", 75, 10),
    ], window_s=1e-3)
    assert trace.busy_s == pytest.approx((10 + 25 + 5) * 1e-6)
    assert trace.span_device_s("inner") == pytest.approx([10e-6])
    assert trace.span_device_s("outer") == pytest.approx([30e-6])
    assert trace.span_extent_s("outer") == pytest.approx([60e-6])
    assert trace.top_device_ops()[0] == ["k2", pytest.approx(20e-6)]
    gaps = dict(trace.idle_gaps())
    assert gaps == {"inner": pytest.approx(30e-6), "outer": pytest.approx(115e-6)}
