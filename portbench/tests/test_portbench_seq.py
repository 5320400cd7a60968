"""The sequence cell (``seq-swarm-10k.gc``): its frozen generators equal the
port's where they share parameters; its plain reference equals
``workload.seq_view``'s fold and the program at a small size; the cell,
at a tiny size on the program's CPU twins, comes out correct, and not
correct under the control and under each planted fault; and each of its
per-layer readers reads its span on a synthetic trace.  On the card a
traced tiny run reports every one of its metrics, and the mix and the
faults are read again at the cell's own size."""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from crdt_tpu_torch import workload
from crdt_tpu_torch.models import rseq, rseq_columnar as rc, rseq_engine
from crdt_tpu_torch.utils.tree import tree_map
from portbench import gen, gen_seq, harness, reference_seq, roofline, roofline_seq
from portbench.systems import seq_gc_swarm
from portbench.tests.conftest import ROOT, TINY, copy_benchmark
from portbench.tests.test_portbench_imports import BANNED, top_names
from portbench.tests.test_portbench_spans import three_spans
from portbench.traces import Trace

CELL = "seq-swarm-10k.gc"
SEQ_TINY = {"replicas": 256, "capacity": 128, "elements": 100, "writers": 4, "run_max": 8}
SPEC = harness.Spec(ROOT)
CONFIG = SPEC.config(SPEC.cells[CELL])


@pytest.fixture
def seq_root(tmp_path):
    return copy_benchmark(tmp_path, dict(TINY, **{"seq-swarm-10k": SEQ_TINY}))


def run(root, seed=2**31 + 11, system=None, trace=False, seconds=0.3):
    return harness.run_cell(root, CELL, seed, seconds, trace, "cpu", time.perf_counter(),
                            system=system)["result"]


# ---- the generators and the reference ----


@pytest.mark.parametrize("name", ["gen_seq.py", "reference_seq.py", "roofline_seq.py"])
def test_yardstick_imports_nothing_of_the_program_or_jax(name):
    names = top_names(ROOT / "portbench" / name)
    assert not names & BANNED and "crdt_tpu_torch" not in names


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_frozen_generators_equal_the_ports(seed):
    pool = gen_seq.seq_pool(seed, depth=rseq.DEPTH, writers=workload.SEQ_WRITERS,
                            run_max=workload.SEQ_RUN_MAX, elements=200,
                            removable=workload.SEQ_REMOVABLE)
    want = workload.seq_pool(seed, n_elements=200)
    for f in ("keys", "elem", "removable"):
        np.testing.assert_array_equal(getattr(pool, f), getattr(want, f))
    t, held, seen = gen_seq.seq_swarm(pool, 40, 64, seed + 1, hold=workload.SEQ_HOLD,
                                      seen_remove=workload.SEQ_SEEN_REMOVE, device="cpu")
    sw = workload.seq_swarm(want, 40, 64, seed + 1, device="cpu")
    assert torch.equal(held, sw.held) and torch.equal(seen, sw.seen)
    for f in ("keys", "elem", "removed"):
        assert torch.equal(t[f], getattr(sw.states, f)), f


def small_pool(seed=3, writers=4, guest=1, elements=60):
    return gen_seq.seq_pool(seed, depth=rseq.DEPTH, writers=writers + guest, run_max=8,
                            elements=elements, removable=0.25)


def test_reference_equals_the_plain_fold_with_no_floors():
    """With every floor -1 a join is a plain union, as workload.seq_view
    folds it; the barrier then collects every removed element of the
    tracked writers, and leaves the live ones in key order."""
    pool = small_pool(guest=0)
    ids = reference_seq.Ids.of(pool, "cpu")
    _, held, seen = gen_seq.seq_swarm(pool, 6, 64, 9, hold=0.4, seen_remove=0.5, device="cpu")
    st = reference_seq.State(held, seen, torch.full((6, 4), -1, dtype=torch.int32))
    acc = st.lanes(slice(0, 1))
    for k in range(1, 6):
        acc, n = reference_seq.join(acc, st.lanes(slice(k, k + 1)), ids, 64)
        assert int(n) == int(acc.held.sum())
    tombs, live = workload.seq_view(pool, held.numpy(), seen.numpy())
    got = {(int(pool.rid[i]), int(pool.seq[i])): bool(acc.seen[0, i])
           for i in np.nonzero(acc.held[0].numpy())[0]}
    assert got == tombs
    out, most, collected = reference_seq.barrier(st, torch.ones(6, dtype=torch.bool), ids, 64)
    assert most >= len(tombs) and collected == 6 * sum(tombs.values())
    for lane in range(6):
        assert pool.elem[out.held[lane].numpy()].tolist() == live


def test_reference_equals_the_program_at_a_small_size():
    """Pull rounds and the barrier on one snapshot: the program's tables,
    floors, unique counts and collected rows are the reference's."""
    pool = small_pool()
    ids = reference_seq.Ids.of(pool, "cpu")
    snap = gen_seq.gc_snapshot(pool, 50, 64, 5, writers=4, prior_floor=0.5, stale_fraction=0.1,
                               hold=0.1, spread=0.5, seen_remove=0.5, down=2, device="cpu")
    assert bool(snap.stale.any()) and not bool(snap.alive.all())
    port = seq_gc_swarm.Port()
    sw = port.plan(pool, snap, 64)
    st = reference_seq.State(snap.held, snap.seen, snap.floor)
    g = torch.Generator().manual_seed(6)
    for _ in range(4):
        peers = gen.random_peers(g, 50)
        sw, n = port.gossip(sw, peers)
        st, want_n = reference_seq.pull_round(st, peers, snap.alive, ids, 64)
        assert torch.equal(n.long(), want_n)
        assert reference_seq.lanes_wrong(port.tables(sw), st, pool, 64) == 0
    sw, most, collected = port.barrier(sw)
    st, want_most, want_collected = reference_seq.barrier(st, snap.alive, ids, 64)
    assert (int(most), int(collected)) == (want_most, want_collected) and want_collected > 0
    assert reference_seq.lanes_wrong(port.tables(sw), st, pool, 64) == 0
    assert reference_seq.floor_lanes_wrong(port.floors(sw), st) == 0


def test_roofline_bytes_of_the_cells_pull():
    n = roofline_seq.gc_pull_bytes(1024, 10240, 6)
    assert n == (2 * 21 + 42) * 1024 * 10240 * 4 + 4 * 10240
    assert roofline.bound_s(n) * 1e3 == pytest.approx(1.0517, abs=1e-4)


# ---- the cell on the CPU twins ----


@pytest.mark.parametrize("trace", [False, True])
def test_cell_is_correct_on_the_cpu(seq_root, trace):
    r = run(seq_root, trace=trace)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["compared"]) == {"pull_lanes_wrong", "gc_lanes_wrong", "floor_lanes_wrong",
                                  "down_lane_wrong", "collected_wrong", "n_unique_wrong",
                                  "overflow_epochs"}
    if not trace:
        # the window holds an epoch or two here; epoch_ms_p95 needs two
        assert {m["name"] for m in SPEC.metrics(SPEC.cells[CELL], False)} == \
            {"merges_per_s", "epoch_ms_p95", "setup_s"}
        assert {"merges_per_s", "setup_s"} <= set(r["metrics"]) <= \
            {"merges_per_s", "epoch_ms_p95", "setup_s"}
    else:
        # no device: the readers of device work and of launches find nothing
        assert r["metrics"] == {}


def test_control_is_not_correct(seq_root):
    r = run(seq_root, system=seq_gc_swarm.Control())
    assert not r["correct"]
    assert sum(c["value"] > c["limit"] for c in r["compared"].values()) >= 1


def test_a_one_epoch_window_is_checked(seq_root):
    r = run(seq_root, system=seq_gc_swarm.Control(), seconds=0)
    assert r["attempted"] == 1 and not r["correct"], r["compared"]


def _pull_ignores_floors(real):
    """A plain RSeq union in the pull: the floors take nothing out."""
    def gc_gossip_round(cg, peers, alive, counts=None):
        peers = peers.long()
        peer = tree_map(lambda x: x[..., peers], cg)
        col, n = rc.merge_checked(cg.col, peer.col)
        merged = rseq_engine.ColumnarGc(col=col, floor=torch.maximum(cg.floor, peer.floor))
        ok = alive & alive[peers]
        return tree_map(lambda m, x: torch.where(ok, m, x), merged, cg), torch.where(ok, n, 0)
    return gc_gossip_round


def _collect_ignores_the_floor(real):
    """Every removed row dropped, whether the new floor covers it or not."""
    def _collect(col, floor):
        valid = col.keys[0] != gen.SENTINEL
        drop = valid & (col.removed != 0)
        out, _ = rseq_engine._compact(col.keys, col.elem, col.removed, drop, valid,
                                      col.capacity, col.seq_bits)
        return out, drop
    return _collect


def _barrier_keeps_state(real):
    def gc_barrier_checked(self):
        _, n, collected = real(self)
        return self, n, collected
    return gc_barrier_checked


def _down_replica_pulls(real):
    def gc_gossip_round(cg, peers, alive, counts=None):
        return real(cg, peers, torch.ones_like(alive), counts)
    return gc_gossip_round


def plant_a_guest_writer(monkeypatch):
    """One more writer in the document, outside the GC membership: the
    floors never cover its rows, so its removed rows outlive the barrier.
    The cell's mix has none (see test_the_mix_has_what_each_fault_needs)."""
    real = seq_gc_swarm._pool
    monkeypatch.setattr(seq_gc_swarm, "_pool",
                        lambda config, seed: real(dict(config, writers=config["writers"] + 1),
                                                  seed))


# fault -> (owner, name, the broken version, whether it needs a guest writer)
FAULTS = {
    "a pull that ignores the floors": (
        rseq_engine, "gc_gossip_round", _pull_ignores_floors, False),
    "a collect of removed rows the frontier does not cover": (
        rseq_engine, "_collect", _collect_ignores_the_floor, True),
    "a barrier that returns its input with the true counts": (
        rseq_engine.GcSwarm, "gc_barrier_checked", _barrier_keeps_state, False),
    "the down replica pulls": (rseq_engine, "gc_gossip_round", _down_replica_pulls, False),
}


def plant(monkeypatch, fault):
    owner, name, broken, guest = FAULTS[fault]
    monkeypatch.setattr(owner, name, broken(getattr(owner, name)))
    if guest:
        plant_a_guest_writer(monkeypatch)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(seq_root, monkeypatch, fault):
    plant(monkeypatch, fault)
    r = run(seq_root)
    assert not r["correct"], (fault, r["compared"])


def mix_readings(cell, s: int = 0, b: int = 0) -> dict:
    """What snapshot s under draw b gives each fault to show, from the
    reference: the stale replicas; over the pull rounds that are kept, the
    rows the floor rule takes from the puller's side (the peer's floor
    covers them) and from the peer's side (the puller's floor); the rows
    the barrier collects; and the removed rows it leaves on the up
    replicas."""
    snap, ids, c = cell.snaps[s], cell.ids, cell.c
    st = reference_seq.State(snap.held, snap.seen, snap.floor)
    own = theirs = 0
    for peers in cell.bank[b]:
        ok = (snap.alive & snap.alive[peers])[:, None]
        peer = st.lanes(peers)
        own += int((ok & st.held & ~peer.held & reference_seq.covered(peer.floor, ids)).sum())
        theirs += int((ok & peer.held & ~st.held & reference_seq.covered(st.floor, ids)).sum())
        st, _ = reference_seq.pull_round(st, peers, snap.alive, ids, c)
    final, _, collected = reference_seq.barrier(st, snap.alive, ids, c)
    return {"stale_replicas": int(snap.stale.sum()), "suppressed_puller_rows": own,
            "suppressed_peer_rows": theirs, "collected": collected,
            "removed_rows_left": int((final.seen & snap.alive[:, None]).sum())}


def check_the_mix(cell, config: dict, guest: bool) -> dict:
    got = mix_readings(cell)
    assert got["stale_replicas"] == round(config["stale_fraction"] * config["replicas"]) >= 1
    assert got["suppressed_puller_rows"] > 0 and got["suppressed_peer_rows"] > 0, got
    assert got["collected"] > 0, got
    # after convergence the frontier is the bound's own watermark, so every
    # removed row of a tracked writer is covered: only a guest writer's stay
    assert (got["removed_rows_left"] > 0) == guest, got
    return got


@pytest.mark.parametrize("guest", [False, True])
def test_the_mix_has_what_each_fault_needs(seq_root, monkeypatch, guest):
    """At the tiny size: stale floors, rows the floor rule takes from
    either side of a pull, and rows to collect.  Removed rows the
    frontier does not cover exist only with a guest writer, which is why
    the collect's coverage fault is planted with one.  The program's
    counter of suppressed rows grows with a pull that suppresses."""
    if guest:
        plant_a_guest_writer(monkeypatch)
    config = harness.Spec(seq_root).config(SPEC.cells[CELL])
    cell = seq_gc_swarm.Cell(config, SPEC.traffic(SPEC.cells[CELL]), 2**31 + 11, "cpu")
    check_the_mix(cell, config, guest)
    for sw in cell.states:
        cell.system.barrier(sw)
    counts = cell.system.counters()["gc_rows"]
    assert counts["collected"] > 0 and counts["suppressed"] == 0
    cell.system.gossip(cell.states[0], cell.bank[0][0])
    assert cell.system.counters()["gc_rows"]["suppressed"] > 0


# ---- the readers of the program's spans ----

DEVICE_READERS = {
    "gc_pull_ms.seq": "rseq_engine.gc_gossip_round",
    "gc_suppress_ms.seq": "rseq_engine.gc_gossip_round.suppress",
    "gc_collect_ms.seq": "rseq_engine.gc_barrier.collect",
}
NEW = ("gc_pull_ms.seq", "gc_pull_roofline.seq", "gc_suppress_ms.seq", "gc_barrier_ms.seq",
       "gc_collect_ms.seq", "launches_per_epoch.seq")


def read(name, trace, **kw):
    return SPEC.reader(name)(SimpleNamespace(trace=trace, config=CONFIG, **kw))


@pytest.mark.parametrize("name", sorted(DEVICE_READERS))
def test_device_reader_takes_the_median_over_spans_that_launched_work(name):
    trace = Trace(three_spans(DEVICE_READERS[name]), window_s=1e-3)
    assert read(name, trace) == pytest.approx(7.5e-3)
    assert read(name, Trace(three_spans(DEVICE_READERS[name] + ".other"), 1e-3)) is None
    assert read(name, None) is None


def test_barrier_reader_takes_the_median_device_extent():
    # the first span's work runs from 30 to 46 us, the second's 130 to 142
    trace = Trace(three_spans("rseq_engine.gc_barrier"), window_s=1e-3)
    assert read("gc_barrier_ms.seq", trace) == pytest.approx(14e-3)
    assert read("gc_barrier_ms.seq", Trace(three_spans("other"), 1e-3)) is None


def test_roofline_reader_divides_the_bound_by_the_unions_device_time():
    trace = Trace(three_spans("rseq_engine.gc_gossip_round.union"), window_s=1e-3)
    n_bytes = roofline_seq.gc_pull_bytes(CONFIG["capacity"], CONFIG["replicas"], CONFIG["depth"])
    want = 100 * 2 * roofline.bound_s(n_bytes) / 15e-6
    assert read("gc_pull_roofline.seq", trace) == pytest.approx(want)
    assert read("gc_pull_roofline.seq", Trace(three_spans("other"), 1e-3)) is None


def test_launches_reader_counts_launches_an_epoch():
    assert read("launches_per_epoch.seq", None, counters={"launches": {"lexn_union": 30}},
                totals={"epochs": 3}) == 10
    assert read("launches_per_epoch.seq", None, counters={}, totals={"epochs": 3}) is None


def test_new_metrics_are_reported_by_the_sequence_cell_alone():
    for name in NEW:
        cells = [c for c, entry in SPEC.cells.items()
                 if name in {m["name"] for m in SPEC.metrics(entry, True)}]
        assert cells == [CELL], name


@pytest.mark.cuda
def test_traced_tiny_cell_on_the_card_reports_every_metric(seq_root):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    r = harness.run_cell(seq_root, CELL, 2**31 + 5, 0.5, True, "cuda",
                         time.perf_counter())["result"]
    assert r["correct"], r["compared"]
    for name in NEW:
        assert r["metrics"][name]["value"] > 0, name
    assert r["metrics"]["gc_pull_roofline.seq"]["value"] < 100
    assert r["device"]["busy_s"] > 0


# ---- the cell's own shape, on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("guest", [False, True])
def test_the_mix_at_the_cells_shape_on_the_card(monkeypatch, guest):
    """The readings of test_the_mix_has_what_each_fault_needs at the cell's
    own size and seed kind (printed, for the record)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    if guest:
        plant_a_guest_writer(monkeypatch)
    cell = seq_gc_swarm.Cell(CONFIG, SPEC.traffic(SPEC.cells[CELL]), 2**31 + 11, "cuda")
    print("mix at the cell's shape", "guest" if guest else "named", check_the_mix(cell, CONFIG, guest))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS) + ["the control"])
def test_fault_at_the_cells_shape_on_the_card(monkeypatch, fault):
    """Each planted fault, and the control, comes out not correct at the
    cell's own size: a one-epoch window of the full configuration."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    system = seq_gc_swarm.Control() if fault == "the control" else None
    if system is None:
        plant(monkeypatch, fault)
    r = harness.run_cell(ROOT, CELL, 2**31 + 13, 0, False, "cuda", time.perf_counter(),
                         system=system)["result"]
    print(fault, {k: c["value"] for k, c in r["compared"].items()})
    assert not r["correct"], (fault, r["compared"])
