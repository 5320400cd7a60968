"""The port node's native wire store (crdt_tpu_torch.native.WireStore
behind ReplicaNode.gossip_payload_json) against the JAX node's native
one, zero tolerance: the same calls to a JAX node and a port node (both
native, each on a ManualClock at 1000) give byte-equal GET /gossip bodies,
which parse to the Python payload; full dumps, deltas, pruning, compaction
sections, foreign ops, adversarial strings and restores.  Follows
tests/test_wire_store.py case by case."""
import json

import pytest

from crdt_tpu.api import node as jnode
from crdt_tpu.utils import checkpoint as jckpt
from crdt_tpu.utils import clock as jclock
from crdt_tpu_torch.api import node as tnode
from crdt_tpu_torch.utils import checkpoint as tckpt
from crdt_tpu_torch.utils import clock as tclock
from tests.native_build import require_jax_native


class Twin:
    """A JAX node and a port node, both native, given every call."""

    def __init__(self, rid=0):
        require_jax_native()
        self.j = jnode.ReplicaNode(rid=rid, clock=jclock.ManualClock(start=1000), use_native=True)
        self.t = tnode.ReplicaNode(rid=rid, clock=tclock.ManualClock(start=1000), device="cpu")
        assert self.t._wire is not None

    def both(self, name, *args, **kw):
        a = getattr(self.j, name)(*args, **kw)
        b = getattr(self.t, name)(*args, **kw)
        assert a == b, (name, a, b)
        return b

    def body(self, since=None):
        """The port's bytes, after checking them against the JAX node's and
        the port's own Python payload."""
        bj, bt = self.j.gossip_payload_json(since), self.t.gossip_payload_json(since)
        assert bt == bj
        assert json.loads(bt) == self.t.gossip_payload(since)
        return bt


def test_full_dump_matches_python():
    n = Twin()
    n.both("add_command", {"x": "5", "y": "hello"})
    n.both("add_command", {"x": "-3"})
    body = n.body()
    assert len(json.loads(body)) == 2 and b" " not in body


def test_delta_matches_python():
    a, b = Twin(0), Twin(1)
    a.both("add_command", {"x": "1"})
    a.both("add_command", {"y": "2"})
    b.j.receive(a.j.gossip_payload())
    b.t.receive(a.t.gossip_payload())
    b.both("add_command", {"z": "3"})
    since = b.both("version_vector")
    assert json.loads(a.body(since)) == {}
    assert len(json.loads(a.body({0: 0}))) == 1


def test_adversarial_strings():
    n = Twin()
    nasty = {'k"quote': 'v\\backslash', "k\nnewline": "v\ttab", "k\x01ctrl": "v\x1f",
             "kλ∀-unicode": "v—em🎉", "": "", "k\x00nul": "\x7f\b\f\r"}
    for k, v in nasty.items():
        n.both("add_command", {k: v})
    got = json.loads(n.body())
    assert sorted(list(c.items())[0] for c in got.values()) == sorted(nasty.items())
    n.both("add_commands", [{k + "2": v} for k, v in nasty.items()])
    n.body()
    n.body({0: 3})


def test_receive_roundtrip_via_json():
    a, b = Twin(0), Twin(1)
    a.both("add_command", {"x": "5", "s": 'he said "hi"'})
    b.j.receive(json.loads(a.j.gossip_payload_json()))
    b.t.receive(json.loads(a.t.gossip_payload_json()))
    assert b.both("get_state") == a.both("get_state")
    b.body()


def test_prune_mirrors_wire_store():
    n = Twin()
    for i in range(5):
        n.both("add_command", {f"k{i}": str(i)})
    n.both("add_commands", [{"b": "1"}, {"c": "2"}])  # write-behind appends
    n.t._flush_wire_locked()
    assert len(n.t._wire) == 7
    n.both("compact", {0: 2})  # folds seqs 0..2
    assert len(n.t._wire) == len(n.t._commands) == len(n.j._wire) == 4
    n.body(n.t.version_vector())


def test_compaction_sections_fall_back_to_python():
    n = Twin()
    for _ in range(4):
        n.both("add_command", {"a": "1"})
    n.both("compact", {0: 3})
    body = json.loads(n.body({}))
    assert "__frontier__" in body and "__summary__" in body


def test_foreign_ops_always_shipped():
    n = Twin()
    n.both("receive", {"123456:-1:0": {"go": "7"}})
    n.both("add_command", {"x": "1"})
    got = json.loads(n.body({0: 0}))
    assert len(got) == 1 and list(got.values())[0] == {"go": "7"}


def test_dead_node_returns_none():
    n = Twin()
    n.both("set_alive", False)
    assert n.t.gossip_payload_json() is None is n.j.gossip_payload_json()


def test_restore_rebuilds_wire(tmp_path):
    n = Twin()
    n.both("add_command", {"x": "5"})
    n.both("add_commands", [{"y": "6"}, {"z": "w"}])
    for mod, node, name in ((jckpt, n.j, "j"), (tckpt, n.t, "t")):
        mod.save_node(str(tmp_path / name), node)
    m = Twin()
    jckpt.restore_node(str(tmp_path / "j"), m.j)
    tckpt.restore_node(str(tmp_path / "t"), m.t)
    assert m.body() == n.body()
    assert len(m.t._wire) == len(m.t._commands) == 3 and not m.t._wire_pending


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_go_compat_full_dump_serves_json_dumps(native):
    """A go-compat node's full dump is json.dumps of bare integer-ms keys
    on both paths, as the JAX node's; its delta is the wire store's."""
    if native:
        require_jax_native()
    jn = jnode.ReplicaNode(rid=0, clock=jclock.ManualClock(start=5), use_native=native,
                           go_compat_gossip=True)
    tn = tnode.ReplicaNode(rid=0, clock=tclock.ManualClock(start=5), use_native=native,
                           go_compat_gossip=True, device="cpu")
    for node in (jn, tn):
        node.add_command({"a": "1"})
        node.add_command({"b": "2"})
    for since in (None, {}, {0: 0}):
        assert tn.gossip_payload_json(since) == jn.gossip_payload_json(since)
    assert json.loads(tn.gossip_payload_json()) == {"5": {"b": "2"}}
