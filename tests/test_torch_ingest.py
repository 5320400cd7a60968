"""The port's ingest front door (crdt_tpu_torch.ingest) against the JAX
package's (crdt_tpu.ingest), at zero tolerance: the page wire format
(equal bytes, equal rows, or PageFormatError at the same inputs), the
shed policy, the admission lanes' batching, expiry and failures, and a
front door over a node in each package taking the same page sequence."""
import random
import struct
import zlib

import numpy as np
import pytest

from crdt_tpu.api import node as jnode
from crdt_tpu.ingest import admission as jadm
from crdt_tpu.ingest import shed as jshed
from crdt_tpu.ingest import wire as jwire
from crdt_tpu.utils import clock as jclock
from crdt_tpu.utils import config as jconfig
from crdt_tpu_torch.api import node as tnode
from crdt_tpu_torch.api.mapnode import MapNode
from crdt_tpu_torch.ingest import admission as tadm
from crdt_tpu_torch.ingest import shed as tshed
from crdt_tpu_torch.ingest import wire as twire
from crdt_tpu_torch.utils import clock as tclock
from crdt_tpu_torch.utils import config as tconfig
from crdt_tpu_torch.utils.metrics import Metrics
from tests.test_torch_node import assert_logs_equal


def seeded_page(wire, seed: int, n: int = 12):
    rng = random.Random(seed)
    nk, nv = max(1, n // 3), max(1, n // 2)
    keys = [f"k{i}" + "é" * (i % 2) for i in range(nk)]
    values = [str(rng.randrange(-50, 50)) for _ in range(nv)]
    ts = [wire.WIRE_TS_NOW if rng.random() < 0.3 else rng.randrange(0, 2**31 - 1)
          for _ in range(n)]
    return wire.OpPage(origin=rng.randrange(0, 100), page_seq=rng.randrange(0, 1000),
                       seq=np.cumsum(np.asarray([rng.randrange(1, 4) for _ in range(n)]),
                                     dtype=np.int64).astype(np.uint32),
                       wire_ts=np.asarray(ts, np.int32),
                       key_id=np.asarray([rng.randrange(nk) for _ in range(n)], np.uint32),
                       val_id=np.asarray([rng.randrange(nv) for _ in range(n)], np.uint32),
                       keys=keys, values=values)


def decode_both(raw: bytes):
    """decode_page in both packages: the same rows, or PageFormatError in
    both with the same message."""
    try:
        jp = jwire.decode_page(raw)
    except jwire.PageFormatError as e:
        with pytest.raises(twire.PageFormatError) as got:
            twire.decode_page(raw)
        assert str(got.value) == str(e)
        return None
    tp = twire.decode_page(raw)
    assert (tp.origin, tp.page_seq, tp.keys, tp.values) == \
        (jp.origin, jp.page_seq, jp.keys, jp.values)
    for f in ("seq", "wire_ts", "key_id", "val_id"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    assert tp.rows() == jp.rows()
    return tp


@pytest.mark.parametrize("seed", range(6))
def test_encode_decode_same_bytes_and_rows(seed):
    n = (1, 7, 64, 300, 12, 2)[seed]
    raw = jwire.encode_page(seeded_page(jwire, seed, n))
    assert twire.encode_page(seeded_page(twire, seed, n)) == raw
    assert decode_both(raw).n_ops == n


def _u32(x: int) -> bytes:
    return int(x).to_bytes(4, "little")


MUTATIONS = {
    "bad magic": lambda raw: b"NOTAPAGE" + raw[8:],
    "version": lambda raw: raw[:8] + b"\xff\x00" + raw[10:],
    "flags": lambda raw: raw[:10] + b"\x01\x00" + raw[12:],
    "negative origin": lambda raw: raw[:12] + (-1).to_bytes(4, "little", signed=True) + raw[16:],
    "zero ops": lambda raw: raw[:20] + _u32(0) + raw[24:],
    "ops over cap": lambda raw: raw[:20] + _u32(twire.MAX_OPS_PER_PAGE + 1) + raw[24:],
    "table over cap": lambda raw: raw[:24] + _u32(twire.MAX_TABLE_BYTES + 1) + raw[28:],
    "truncated tail": lambda raw: raw[:-1],
    "trailing garbage": lambda raw: raw + b"\x00",
    "bad crc": lambda raw: raw[:32] + b"\x00\x00\x00\x00" + raw[36:],
    "short header": lambda raw: raw[:20],
    "empty": lambda raw: b"",
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_malformed_header_rejected_alike(name):
    decode_both(MUTATIONS[name](jwire.encode_page(seeded_page(jwire, 3))))


def _repacked(page_fn, wire):
    """Encode a page, applying ``page_fn`` to the OpPage first (a defect
    behind a valid crc)."""
    p = seeded_page(wire, 5, 6)
    page_fn(p)
    return wire.encode_page(p)


BODY_DEFECTS = {
    "seq not increasing": lambda p: setattr(p, "seq", np.asarray([0, 2, 1, 3, 4, 5], np.uint32)),
    "wire ts out of window": lambda p: setattr(p, "wire_ts", np.asarray([5, -7, 0, 0, 0, 0],
                                                                         np.int32)),
    "key id out of table": lambda p: setattr(p, "key_id", np.asarray([0, 99, 0, 0, 0, 0],
                                                                      np.uint32)),
    "value id out of table": lambda p: setattr(p, "val_id", np.asarray([0, 0, 99, 0, 0, 0],
                                                                        np.uint32)),
    "key not utf-8": None,  # spliced in as raw bytes below
}


@pytest.mark.parametrize("name", sorted(BODY_DEFECTS))
def test_malformed_body_rejected_alike(name):
    if name == "key not utf-8":
        # an invalid table entry behind a valid crc
        raw = jwire.encode_page(seeded_page(jwire, 5, 6))
        n = struct.unpack_from("<I", raw, 20)[0]
        kt = struct.pack("<II", 1, 2) + b"\xc3\x28"
        vt_start = 36 + 16 * n + struct.unpack_from("<I", raw, 24)[0]
        payload = raw[36:36 + 16 * n] + kt + raw[vt_start:]
        header = jwire._HEADER.pack(jwire.MAGIC, 1, 0, 0, 0, n, len(kt),
                                    len(raw) - vt_start, zlib.crc32(payload))
        raw = header + payload
    else:
        raw = _repacked(BODY_DEFECTS[name], jwire)
        assert _repacked(BODY_DEFECTS[name], twire) == raw
    decode_both(raw)


def test_truncations_and_flips_alike():
    """Every proper prefix of a page, and 200 seeded single-bit flips."""
    raw = jwire.encode_page(seeded_page(jwire, 8, 9))
    for cut in range(len(raw)):
        assert decode_both(raw[:cut]) is None
    rng = random.Random(42)
    for _ in range(200):
        pos = rng.randrange(len(raw))
        bad = raw[:pos] + bytes([raw[pos] ^ (1 << rng.randrange(8))]) + raw[pos + 1:]
        decode_both(bad)


def test_page_builder_same_pages():
    rng = random.Random(4)
    builders = [w.PageBuilder(origin=17, page_size=50) for w in (jwire, twire)]
    for i in range(230):
        key, value, ts = f"k{rng.randrange(9)}", str(rng.randrange(-20, 0)), rng.choice(
            [jwire.WIRE_TS_NOW, i])
        assert builders[0].add(key, value, ts) == builders[1].add(key, value, ts)
    assert builders[0].flush() == builders[1].flush()
    assert builders[0].flush() is builders[1].flush() is None


def counters_and_gauges(metrics):
    """A Metrics' counter and gauge series (either package's)."""
    with metrics.registry._lock:
        return dict(metrics.registry._counters), dict(metrics.registry._gauges)


@pytest.mark.parametrize("high_water,sizes", [(10, [3, 4, 3, 1, 12, 2]), (4096, [5000]),
                                               (8, [8, 1, 0, 7])])
def test_shed_policy_alike(high_water, sizes):
    from crdt_tpu.obs.events import EventLog as JEvents
    from crdt_tpu.utils.metrics import Metrics as JMetrics
    from crdt_tpu_torch.obs.events import EventLog as TEvents

    pj = jshed.ShedPolicy(high_water=high_water, retry_after_s=0.25)
    pt = tshed.ShedPolicy(high_water=high_water, retry_after_s=0.25)
    mj, mt, ej, et = JMetrics(), Metrics(), JEvents(node="n"), TEvents(node="n")
    depth = 0
    for n in sizes:
        assert pj.would_shed(depth, n) == pt.would_shed(depth, n)
        if pt.would_shed(depth, n):
            a = pj.shed("kv", n, depth, mj, ej, "n", tenant="t" if n % 2 else None)
            b = pt.shed("kv", n, depth, mt, et, "n", tenant="t" if n % 2 else None)
            assert str(a) == str(b)
            assert (a.lane, a.n_ops, a.depth, a.high_water, a.retry_after_s, a.tenant) == \
                (b.lane, b.n_ops, b.depth, b.high_water, b.retry_after_s, b.tenant)
        else:
            depth += n
    assert counters_and_gauges(mj) == counters_and_gauges(mt)
    strip = [{k: v for k, v in r.items() if k != "ts_ms"} for r in ej.find()]
    assert strip == [{k: v for k, v in r.items() if k != "ts_ms"} for r in et.find()]


def _lanes(max_batch, high_water, fail_at=None):
    """One admission lane per package over a recording flush function."""
    out = []
    for adm, shed in ((jadm, jshed), (tadm, tshed)):
        seen = []

        def flush(items, seen=seen):
            seen.append(list(items))
            if fail_at is not None and len(seen) == fail_at:
                raise RuntimeError("flush failed")
            return [x * 10 for x in items]

        lane = adm.AdmissionQueue("kv", flush, max_batch=max_batch, flush_deadline_s=0.001,
                                  policy=shed.ShedPolicy(high_water=high_water), node="7")
        out.append((lane, seen, shed))
    return out


@pytest.mark.parametrize("max_batch,high_water,fail_at", [(4, 100, None), (64, 12, None),
                                                          (3, 100, 2)])
def test_admission_lane_batching_expiry_failures_alike(max_batch, high_water, fail_at):
    """The same submissions (groups, singles, an over-mark group) through
    a lane in each package: the same drains, results, sheds, errors and
    accounting; flush_expired only past the deadline."""
    results = []
    for lane, seen, shed in _lanes(max_batch, high_water, fail_at):
        rec = []
        x = 0
        for size in (1, 2, 1, 5, 13, 1, 3):
            items = list(range(x, x + size))
            x += size
            try:
                t = lane.submit_many(items)
            except shed.ShedError as e:
                rec.append(("shed", e.n_ops, e.depth))
                continue
            rec.append(("depth", lane.depth))
            if t.done:
                try:
                    rec.append(("early", t.wait(1)))
                except RuntimeError as e:
                    rec.append(("error", str(e)))
        assert lane.flush_expired(now=0.0) == 0  # not past the deadline
        try:
            rec.append(("flushed", lane.flush()))
        except RuntimeError as e:
            rec.append(("error", str(e)))
        rec.append(("flush_empty", lane.flush()))
        t = lane.submit(99)
        rec.append(("deadline", t.wait(5)))
        rec.append(("seen", seen))
        reg = lane.metrics.registry
        with reg._lock:
            rec.append(("counters", dict(reg._counters), dict(reg._gauges)))
            rec.append(("hist", {k: h.count for k, h in reg._hists.items()}))
        results.append(rec)
    assert results[0] == results[1]


def _door_pair(**kw):
    jc, tc = jclock.ManualClock(), tclock.ManualClock()
    jn = jnode.ReplicaNode(rid=3, capacity=16, clock=jc, use_native=False)
    tn = tnode.ReplicaNode(rid=3, capacity=16, clock=tc, use_native=False, device="cpu")
    from crdt_tpu.api.mapnode import MapNode as JMapNode

    jd = jadm.front_door_from_config(jn, map_node=JMapNode(rid=3, metrics=jn.metrics),
                                     config=jconfig.ClusterConfig(**kw))
    td = tadm.front_door_from_config(tn, map_node=MapNode(rid=3, metrics=tn.metrics,
                                                          device="cpu"),
                                     config=tconfig.ClusterConfig(**kw))
    return (jn, jd, jc), (tn, td, tc)


def test_front_door_over_nodes_same_page_sequence():
    """A JAX front door over a JAX node and a port front door over a port
    node take the same pages, duplicates, corrupt pages, sheds at
    high_water, single ops, map updates and a down node: equal returns,
    idents, page watermarks, node logs, payloads and counters."""
    (jn, jd, jc), (tn, td, tc) = _door_pair(ingest_high_water=120, ingest_flush_ops=16)
    rng = random.Random(9)
    pages = []
    for p in range(10):
        b = jwire.PageBuilder(origin=500 + p % 3, page_size=1 << 20)
        b._page_seq = p // 3
        for _ in range(rng.choice([5, 40, 130])):
            b.add(f"k{rng.randrange(12)}", str(rng.randrange(-20, -10)),
                  rng.choice([jwire.WIRE_TS_NOW, rng.randrange(0, 1000)]))
        pages.append(b.flush())
    pages.insert(4, pages[2])  # a duplicate
    pages.insert(6, pages[0][:-5])  # a truncated page
    for step, raw in enumerate(pages):
        jc.advance(step % 3)
        tc.advance(step % 3)
        outs = []
        for door in (jd, td):
            try:
                outs.append(("ok", door.admit_page(raw, tenant="t" if step % 2 else None)))
            except (jwire.PageFormatError, twire.PageFormatError) as e:
                outs.append(("quarantined", str(e)))
            except (jshed.ShedError, tshed.ShedError) as e:
                outs.append(("shed", str(e)))
        assert outs[0] == outs[1], step
        assert jd._page_watermark == td._page_watermark
        assert jd.admit_kv({"k1": str(step)}) == td.admit_kv({"k1": str(step)})
        assert jd.admit_map_upd(f"m{step % 4}", step - 3) == td.admit_map_upd(
            f"m{step % 4}", step - 3)
    assert jn.get_state() == tn.get_state()
    assert jn.version_vector() == tn.version_vector()
    assert jn.gossip_payload() == tn.gossip_payload()
    assert_logs_equal(jn, tn)
    assert jd.map_node.items() == td.map_node.items()
    jn.set_alive(False)
    tn.set_alive(False)
    assert jd.admit_kv({"a": "1"}) is td.admit_kv({"a": "1"}) is None
    raw = pages[1]
    raw2 = jwire.encode_page(jwire.OpPage(origin=999, page_seq=0, seq=np.arange(3, dtype=np.uint32),
                                          wire_ts=np.full(3, -1, np.int32),
                                          key_id=np.zeros(3, np.uint32),
                                          val_id=np.zeros(3, np.uint32), keys=["a"], values=["1"]))
    assert jd.admit_page(raw2) == td.admit_page(raw2)  # down: nothing admitted
    assert jd.admit_page(raw) == td.admit_page(raw)
    for name in ("ingest_pages", "ingest_pages_duplicate", "ingest_pages_quarantined"):
        assert jn.metrics.registry.counter_value(name, node="3") == \
            tn.metrics.registry.counter_value(name, node="3")
    for lane in ("kv", "map"):
        for name in ("ingest_drains", "ingest_ops_admitted", "ingest_shed", "ingest_shed_ops"):
            assert jn.metrics.registry.counter_value(name, lane=lane, node="3") == \
                tn.metrics.registry.counter_value(name, lane=lane, node="3"), (name, lane)
    assert tn.metrics.registry.counter_value("ingest_shed", lane="kv", node="3") > 0
    # the replayed page and the last one, admitted before the node went down
    assert tn.metrics.registry.counter_value("ingest_pages_duplicate", node="3") == 2
