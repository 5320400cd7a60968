"""Crash-recovery soak: REAL process kills against a daemon fleet (own
copy of ``crdt_tpu.harness.crashsoak``) — the layer the in-process soaks
cannot reach.

The in-process soaks (:mod:`crdt_tpu_torch.harness.soak`) inject faults
via alive-flag toggles: the process survives, so nothing is ever lost.
This runner spawns each replica as a SUBPROCESS (``python -m
crdt_tpu_torch --daemon --checkpoint-dir ... --device <d>``), SIGKILLs
daemons mid-schedule, and restarts them restoring from their crash-safe
snapshots INTO THE LIVE FLEET while compaction barriers keep running (a
node restored from a pre-barrier snapshot carries a stale compaction
frontier; the chain rule must absorb it).

Fault/durability model (gossip-as-checkpoint):

* A SIGKILL loses every op the daemon minted after its last snapshot —
  UNLESS a peer already pulled it.  The fleet's surviving ops for writer w
  are therefore a per-writer prefix 0..VV[w] where VV is the healed
  fleet's converged version vector.
* A restored daemon boots under a FRESH incarnation rid
  (:mod:`crdt_tpu_torch.utils.checkpoint`): its dead predecessor's ops are
  a frozen writer prefix that flows back through ordinary gossip, and no
  (rid, seq) is ever minted twice.

Invariants checked at heal time:

  I1  durability    — converged state == the oracle fold of exactly the
                      vv-surviving prefix of accepted writes; additionally
                      every explicitly checkpointed write DID survive
                      (VV[rid] >= last-checkpoint watermark), and writers
                      never killed lost nothing.
  I2  availability  — a soft-dead daemon 502s writes; a killed one refuses
                      connections; both count as rejected, never lost-
                      after-accept.
  I3  liveness      — the healed fleet (every daemon restarted) converges
                      within a bounded number of pull rounds.
  I4  safety        — no admin pull/barrier ever 500s: barriers racing
                      kills, restores with stale frontiers, and revival
                      merges are all legal schedules (frontier chain rule).

The SET workload (OR-Set + tombstone GC + floor-carrying deltas) rides
the same kill/restore schedule, GC barriers racing SIGKILLs and restores:

  S1  durability    — converged membership == the observed-remove fold of
                      exactly the vv-surviving set ops (no resurrection of
                      collected tags, no lost removal — both falsify the
                      fold); checkpointed/live-writer watermark rules as I1.
  S2  floor safety  — every node's heal-time GC floor dominates the
                      strongest floor any slot still DURABLY holds
                      (in memory, or in the snapshot a crash reverts it
                      to): a stale restore is absorbed while any durable
                      holder exists.  A fleet-wide revert to pre-barrier
                      snapshots legitimately rolls the floor back
                      (gossip-as-checkpoint: the collected rows revert
                      WITH it).
  S3  safety        — no set pull/collect/barrier ever 500s (the floor
                      chain rule holds on every schedule).

The SEQUENCE workload (RSeq + path keys + tombstone GC over /seq/*) has
Q-invariants mirroring S: Q1 durability (converged membership == the
targeted-remove fold of exactly the vv-surviving seq ops; ORDER is checked
as fleet-wide agreement), Q2 floor safety, Q3 no seq pull/collect/barrier
ever 500s.  The MAP workload (M1-M3: the epoch-filtered PN fold, epoch
dominance, no 500s) and the sharded KEYSPACE tier (K1: per-shard
watermarks and the per-tenant fold, K3: no ks pull 500s) ride it too.

``device`` is every daemon's torch device (``None``: the CUDA card, and
the runner raises without one; the tests pass ``"cpu"``).

    python -m crdt_tpu_torch.harness.crashsoak --steps 200 --seeds 1 --device cuda
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import random
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

from crdt_tpu_torch import default_device

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
RID_STRIDE = 64
KS_SHARDS = 2  # every daemon boots the sharded keyspace tier (K-invariants)


def _free_ports(n: int) -> List[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _http(url: str, method: str = "GET", body: Optional[dict] = None,
          timeout: float = 30.0) -> Tuple[int, bytes]:
    # 30 s, the JAX package's bound: a pull that lands on a daemon that
    # is still widening a sequence or loading a snapshot may be slow
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as res:
            return res.status, res.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _http_hdrs(url: str, method: str = "GET", body: Optional[dict] = None,
               headers: Optional[Dict[str, str]] = None,
               timeout: float = 30.0) -> Tuple[int, bytes, Dict[str, str]]:
    """As _http, but carries request headers out AND response headers back
    (the keyspace workload needs X-CRDT-Tenant in and the minted ident —
    riding the session-token response header — out)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as res:
            return res.status, res.read(), dict(res.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers or {})


class Daemon:
    """One replica slot: a subprocess per boot, a stable port, a stable
    checkpoint dir, and the boot count (the incarnation the NEXT spawn
    will claim)."""

    def __init__(self, slot: int, port: int, peer_urls: List[str],
                 ckpt_dir: str, coordinator: bool, device: str = "cuda"):
        self.slot = slot
        self.device = device
        self.port = port
        self.url = f"http://127.0.0.1:{port}"
        self.peer_urls = peer_urls
        self.ckpt_dir = ckpt_dir
        self.coordinator = coordinator
        self.boots = 0
        self.proc: Optional[subprocess.Popen] = None
        # seconds from each spawn to its first 200 /ping (restart to
        # serving, for the reports that time restores)
        self.spawn_s: List[float] = []

    @property
    def wire_rid(self) -> int:
        """The writer id of the CURRENT boot (matches bump_incarnation)."""
        return self.slot + RID_STRIDE * (self.boots - 1)

    @property
    def event_log_path(self) -> str:
        return str(pathlib.Path(self.ckpt_dir) / "events.jsonl")

    def spawn(self, wait_s: float = 90.0) -> None:
        assert self.proc is None or self.proc.poll() is not None
        argv = [
            sys.executable, "-m", "crdt_tpu_torch", "--daemon",
            "--rid", str(self.slot), "--port", str(self.port),
            "--peers", ",".join(self.peer_urls),
            "--checkpoint-dir", self.ckpt_dir,
            "--rid-stride", str(RID_STRIDE),
            "--gossip-ms", "600000",  # external drive only (determinism)
            # sharded keyspace tier: per-shard snapshot sections ride the
            # same manifest (K-invariants below)
            "--keyspace-shards", str(KS_SHARDS),
            # per-slot black box: every boot of this slot appends to the
            # same JSONL, so a SIGKILLed incarnation's last rounds are
            # readable post-mortem (crdt_tpu_torch.obs.events.read_jsonl
            # tolerates the torn final line)
            "--event-log", self.event_log_path,
            "--device", self.device,
        ]
        if self.coordinator:
            argv.append("--coordinator")
        self.proc = subprocess.Popen(
            argv, cwd=REPO_ROOT,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        self.boots += 1
        t0 = time.perf_counter()
        deadline = time.time() + wait_s
        while time.time() < deadline:
            try:
                code, _ = _http(self.url + "/ping", timeout=2)
                if code == 200:
                    self.spawn_s.append(time.perf_counter() - t0)
                    return
            except (urllib.error.URLError, OSError):
                pass  # not up yet: transport failures only, keep polling
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"daemon slot {self.slot} exited rc={self.proc.returncode}"
                )
            time.sleep(0.1)
        raise RuntimeError(f"daemon slot {self.slot} never became healthy")

    def sigkill(self) -> None:
        assert self.proc is not None and self.proc.poll() is None
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=10)

    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def shutdown(self) -> None:
        if self.running:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


@dataclasses.dataclass
class CrashReport:
    steps: int = 0
    writes_offered: int = 0
    writes_accepted: int = 0
    writes_rejected: int = 0
    pulls: int = 0
    barriers: int = 0
    barriers_empty: int = 0
    checkpoints: int = 0
    soft_kills: int = 0
    soft_revives: int = 0
    sigkills: int = 0
    restores: int = 0
    ops_lost_to_crashes: int = 0
    rounds_to_converge: int = -1
    final_keys: int = 0
    set_adds: int = 0
    set_removes: int = 0
    set_pulls: int = 0
    set_barriers: int = 0
    set_barriers_empty: int = 0
    set_ops_lost: int = 0
    final_members: int = 0
    seq_inserts: int = 0
    seq_removes: int = 0
    seq_pulls: int = 0
    seq_barriers: int = 0
    seq_barriers_empty: int = 0
    seq_ops_lost: int = 0
    final_len: int = 0
    map_upds: int = 0
    map_rems: int = 0
    map_pulls: int = 0
    map_barriers: int = 0         # fired: epochs minted
    map_barriers_noop: int = 0    # fired: nothing stably removed
    map_barriers_skipped: int = 0 # full-fleet rule blocked (churn)
    map_ops_lost: int = 0
    map_peak_records: int = 0     # peak retained records between resets
    final_map_keys: int = 0
    ks_writes: int = 0            # tenant-scoped keyspace writes accepted
    ks_rejected: int = 0          # 502 (down) / 429 (shed) — never lost
    ks_pulls: int = 0             # fresh ops merged by keyspace pulls
    ks_ops_lost: int = 0          # crash-lost keyspace ops (vv-filtered)
    final_ks_keys: int = 0        # qualified keys at heal
    event_lines: int = 0          # JSONL black-box lines across all slots
    event_boots: int = 0          # boot events logged (== fleet incarnations)

    def __str__(self) -> str:
        return (
            f"crash-soak: {self.steps} steps, {self.writes_accepted}/"
            f"{self.writes_offered} writes, {self.pulls} pulls, "
            f"{self.barriers} barriers (+{self.barriers_empty} empty), "
            f"{self.checkpoints} ckpts, {self.sigkills} SIGKILLs / "
            f"{self.restores} restores (+{self.soft_kills}/"
            f"{self.soft_revives} soft), {self.ops_lost_to_crashes} ops "
            f"crash-lost, converged in {self.rounds_to_converge} rounds, "
            f"{self.final_keys} keys; set: {self.set_adds}+{self.set_removes}"
            f" ops, {self.set_pulls} pulls, {self.set_barriers} GC barriers "
            f"(+{self.set_barriers_empty} empty), {self.set_ops_lost} "
            f"crash-lost, {self.final_members} members; seq: "
            f"{self.seq_inserts}+{self.seq_removes} ops, {self.seq_pulls} "
            f"pulls, {self.seq_barriers} GC barriers "
            f"(+{self.seq_barriers_empty} empty), {self.seq_ops_lost} "
            f"crash-lost, len {self.final_len}; map: {self.map_upds}+"
            f"{self.map_rems} ops, {self.map_pulls} pulls, "
            f"{self.map_barriers} resets (+{self.map_barriers_noop} noop, "
            f"{self.map_barriers_skipped} skipped), {self.map_ops_lost} "
            f"crash-lost, peak {self.map_peak_records} records, "
            f"{self.final_map_keys} keys; ks: {self.ks_writes} writes "
            f"(+{self.ks_rejected} rejected), {self.ks_pulls} pulls, "
            f"{self.ks_ops_lost} crash-lost, {self.final_ks_keys} keys; "
            f"black box: {self.event_lines} "
            f"event lines / {self.event_boots} boots"
        )


class CrashSoakRunner:
    """One seeded kill/restore schedule against a subprocess daemon fleet."""

    def __init__(self, n: int = 3, seed: int = 0, n_keys: int = 6,
                 workdir: Optional[str] = None,
                 postmortem_dir: Optional[str] = None,
                 device=None):
        # resolved before anything spawns: no card and no explicit device
        # raises here rather than booting daemons that would fail
        self.device = str(default_device(device))
        self.seed = seed
        self.postmortem_dir = postmortem_dir
        self.rng = random.Random(seed)
        self.keys = [f"k{i}" for i in range(n_keys)]
        self._tmp = (
            tempfile.TemporaryDirectory(prefix="crashsoak-")
            if workdir is None else None
        )
        root = pathlib.Path(workdir or self._tmp.name)
        ports = _free_ports(n)
        urls = [f"http://127.0.0.1:{p}" for p in ports]
        self.daemons = [
            Daemon(
                slot=i, port=ports[i],
                peer_urls=[u for j, u in enumerate(urls) if j != i],
                ckpt_dir=str(root / f"node{i}"),
                coordinator=(i == 0), device=self.device,
            )
            for i in range(n)
        ]
        for d in self.daemons:
            d.spawn()
        # oracle side: every accepted write with its minted identity
        self.ops: List[Tuple[int, int, Dict[str, str]]] = []  # (rid, seq, cmd)
        self.accepted_per_boot: Dict[int, int] = {}   # wire_rid -> count
        self.ckpt_watermark: Dict[int, int] = {}      # wire_rid -> count at ckpt
        # set-lattice oracle: accepted set ops with minted identities —
        # adds (rid, seq, elem) and removes (rid, seq, [targets])
        self.set_adds: List[Tuple[int, int, str]] = []
        self.set_removes: List[Tuple[int, int, List[Tuple[int, int]]]] = []
        self.set_accepted_per_boot: Dict[int, int] = {}
        self.set_ckpt_watermark: Dict[int, int] = {}
        # S2 bookkeeping: the
        # barrier floor is DURABLE only while some daemon holds it in
        # memory or on disk — if every holder is SIGKILLed before
        # checkpointing, the fleet legitimately reverts to pre-barrier
        # state wholesale (gossip-as-checkpoint: nothing was lost,
        # the collected rows come back with the floor).  So the
        # monotonicity bar is per-slot: what each daemon currently holds
        # (queried after barriers) and what its last snapshot would
        # restore.  The heal-time floor must dominate the per-writer max
        # over slots AFTER applying crash reversion — not the last
        # barrier's floor unconditionally.
        self.set_floor_live: Dict[int, Dict[int, int]] = {}
        self.set_floor_ckpt: Dict[int, Dict[int, int]] = {}
        self.set_elems = [f"s{i}" for i in range(n_keys)]
        # sequence-lattice oracle: inserts (rid, seq, elem) with fleet-
        # unique elems, removes (rid, seq, target identity)
        self.seq_inserts: List[Tuple[int, int, str]] = []
        self.seq_removes: List[Tuple[int, int, Tuple[int, int]]] = []
        self.seq_accepted_per_boot: Dict[int, int] = {}
        self.seq_ckpt_watermark: Dict[int, int] = {}
        self.seq_floor_live: Dict[int, Dict[int, int]] = {}   # Q2: as S2
        self.seq_floor_ckpt: Dict[int, Dict[int, int]] = {}
        # map-lattice oracle: upds (rid, seq, key, delta, epoch_at_mint),
        # rems (rid, seq, key, {writer: observed_tok}, epoch_at_mint)
        self.map_upds: List[Tuple[int, int, str, int, int]] = []
        self.map_rems: List[Tuple[int, int, str, Dict[int, int], int]] = []
        self.map_accepted_per_boot: Dict[int, int] = {}
        self.map_ckpt_watermark: Dict[int, int] = {}
        self.map_epoch_live: Dict[int, Dict[str, int]] = {}   # M2: as S2
        self.map_epoch_ckpt: Dict[int, Dict[str, int]] = {}
        self.map_keys = [f"m{i}" for i in range(max(3, n_keys // 2))]
        # keyspace oracle: tenant-scoped writes with daemon-minted idents
        # (the session-token response header).  Seq spaces are PER SHARD
        # (shards share the host rid by design), so every record carries
        # its shard index — computed client-side with the same rendezvous
        # routing the daemons use, which is exactly the determinism the
        # K-invariants lean on.
        self.tenants = ["acme", "globex"]
        self.ks_ops: List[Tuple[int, int, int, str, str, str]] = []
        #             (shard, rid, seq, tenant, key, val)
        self.ks_accepted: Dict[Tuple[int, int], int] = {}  # (rid, shard)
        self.ks_ckpt_watermark: Dict[Tuple[int, int], int] = {}
        from crdt_tpu_torch.keyspace.routing import RendezvousRouter, route_key
        self._ks_router = RendezvousRouter(
            [f"shard-{i}" for i in range(KS_SHARDS)])
        self._ks_route_key = route_key
        self.report = CrashReport()

    # ---- schedule actions ----

    def _write(self) -> None:
        r = self.report
        d = self.rng.choice(self.daemons)
        cmd = {self.rng.choice(self.keys): str(self.rng.randint(-20, 20))}
        r.writes_offered += 1
        if not d.running:
            r.writes_rejected += 1
            return
        code, _ = _http(d.url + "/data", "POST", cmd)
        if code == 200:
            rid = d.wire_rid
            seq = self.accepted_per_boot.get(rid, 0)
            self.accepted_per_boot[rid] = seq + 1
            self.ops.append((rid, seq, dict(cmd)))
            r.writes_accepted += 1
        else:
            r.writes_rejected += 1  # I2: soft-dead 502

    def _running(self) -> List[Daemon]:
        return [d for d in self.daemons if d.running]

    @staticmethod
    def _dict_max(dicts):
        """Per-key max over a list of {k: v} dicts — the strongest floor/
        epoch any slot still durably holds."""
        out = {}
        for d in dicts:
            for k, v in d.items():
                if v > out.get(k, -1):
                    out[k] = v
        return out

    def _query_floor(self, d: Daemon, path: str, field: str = "floor"):
        code, body = _http(d.url + path)
        if code != 200:
            return None
        got = json.loads(body)[field]
        if field == "epochs":
            return {str(k): int(v) for k, v in got.items()}
        return {int(k): int(v) for k, v in got.items()}

    def _refresh_live(self) -> None:
        """Record every running daemon's actual floors/epochs (the
        durable-holder bookkeeping above)."""
        for d in self._running():
            f = self._query_floor(d, "/set/vv")
            if f is not None:
                self.set_floor_live[d.slot] = f
            f = self._query_floor(d, "/seq/vv")
            if f is not None:
                self.seq_floor_live[d.slot] = f
            e = self._query_floor(d, "/map/vv", field="epochs")
            if e is not None:
                self.map_epoch_live[d.slot] = e

    # ---- set-lattice actions (S-invariants) ----

    def _set_write(self) -> None:
        r = self.report
        d = self.rng.choice(self.daemons)
        if not d.running:
            return
        rid = d.wire_rid
        if self.rng.random() < 0.65:
            elem = self.rng.choice(self.set_elems)
            code, body = _http(d.url + "/set/add", "POST", {"elem": elem})
            if code == 200:
                got = json.loads(body)
                seq = self.set_accepted_per_boot.get(rid, 0)
                assert (got["rid"], got["seq"]) == (rid, seq), (
                    f"S1: daemon minted {got['rid']}:{got['seq']}, oracle "
                    f"expected {rid}:{seq}"
                )
                self.set_accepted_per_boot[rid] = seq + 1
                self.set_adds.append((rid, seq, elem))
                r.set_adds += 1
        else:
            elem = self.rng.choice(self.set_elems)
            code, body = _http(d.url + "/set/remove", "POST", {"elem": elem})
            if code == 200:
                got = json.loads(body)
                if got["removed"]:
                    seq = self.set_accepted_per_boot.get(rid, 0)
                    # mirror the add path: a mint divergence must fail HERE,
                    # not surface later as a confusing S1b/S1c failure far
                    # from the cause
                    assert (got["rid"], got["seq"]) == (rid, seq), (
                        f"S1: daemon minted {got['rid']}:{got['seq']} for a "
                        f"remove, oracle expected {rid}:{seq}"
                    )
                    self.set_accepted_per_boot[rid] = seq + 1
                    self.set_removes.append((
                        rid, seq,
                        [tuple(map(int, t)) for t in got["tags"]],
                    ))
                    r.set_removes += 1

    def _set_pull(self) -> None:
        up = self._running()
        if not up:
            return
        d = self.rng.choice(up)
        peer = self.rng.choice(d.peer_urls)
        code, body = _http(d.url + "/admin/set_pull", "POST", {"peer": peer})
        assert code == 200, f"S3: set pull 500d: {body!r}"
        self.report.set_pulls += json.loads(body)["pulled"]

    def _set_barrier(self) -> None:
        d = self.daemons[0]  # the fleet's single coordinator
        if not d.running:
            return
        code, body = _http(d.url + "/admin/set_barrier", "POST", {})
        assert code == 200, f"S3: set barrier 500d: {body!r}"
        floor = {int(k): int(v) for k, v in json.loads(body)["floor"].items()}
        if floor:
            # S2 chain rule: a minted floor dominates every member's
            # current floor (the durable-holder bars, which crash
            # reversion may have lowered — see __init__ note)
            bar = self._dict_max(self.set_floor_live.values())
            for k, v in bar.items():
                assert floor.get(k, -1) >= v, (
                    f"S2: barrier floor regressed at writer {k}: "
                    f"{floor} < holder bar {bar}"
                )
            self._refresh_live()
            self.report.set_barriers += 1
        else:
            self.report.set_barriers_empty += 1

    # ---- sequence-lattice actions (Q-invariants) ----

    def _seq_write(self) -> None:
        r = self.report
        d = self.rng.choice(self.daemons)
        if not d.running:
            return
        rid = d.wire_rid
        idx = self.rng.randint(0, 20)  # daemon clamps to its list length
        if self.rng.random() < 0.65:
            elem = f"q{len(self.seq_inserts)}"
            code, body = _http(d.url + "/seq/insert", "POST",
                               {"elem": elem, "index": idx})
            if code == 200:
                got = json.loads(body)
                seq = self.seq_accepted_per_boot.get(rid, 0)
                assert (got["rid"], got["seq"]) == (rid, seq), (
                    f"Q1: daemon minted {got['rid']}:{got['seq']}, oracle "
                    f"expected {rid}:{seq}"
                )
                self.seq_accepted_per_boot[rid] = seq + 1
                self.seq_inserts.append((rid, seq, elem))
                r.seq_inserts += 1
        else:
            code, body = _http(d.url + "/seq/remove", "POST", {"index": idx})
            if code == 200:
                got = json.loads(body)
                if got["removed"]:
                    seq = self.seq_accepted_per_boot.get(rid, 0)
                    assert (got["rid"], got["seq"]) == (rid, seq), (
                        f"Q1: daemon minted {got['rid']}:{got['seq']} for a "
                        f"remove, oracle expected {rid}:{seq}"
                    )
                    self.seq_accepted_per_boot[rid] = seq + 1
                    self.seq_removes.append((
                        rid, seq, tuple(int(x) for x in got["target"])
                    ))
                    r.seq_removes += 1

    def _seq_pull(self) -> None:
        up = self._running()
        if not up:
            return
        d = self.rng.choice(up)
        peer = self.rng.choice(d.peer_urls)
        code, body = _http(d.url + "/admin/seq_pull", "POST", {"peer": peer})
        assert code == 200, f"Q3: seq pull 500d: {body!r}"
        self.report.seq_pulls += json.loads(body)["pulled"]

    def _seq_barrier(self) -> None:
        d = self.daemons[0]  # the fleet's single coordinator
        if not d.running:
            return
        code, body = _http(d.url + "/admin/seq_barrier", "POST", {})
        assert code == 200, f"Q3: seq barrier 500d: {body!r}"
        floor = {int(k): int(v) for k, v in json.loads(body)["floor"].items()}
        if floor:
            bar = self._dict_max(self.seq_floor_live.values())
            for k, v in bar.items():
                assert floor.get(k, -1) >= v, (
                    f"Q2: barrier floor regressed at writer {k}: "
                    f"{floor} < holder bar {bar}"
                )
            self._refresh_live()
            self.report.seq_barriers += 1
        else:
            self.report.seq_barriers_empty += 1

    # ---- map-lattice actions (M-invariants) ----

    def _map_write(self) -> None:
        r = self.report
        d = self.rng.choice(self.daemons)
        if not d.running:
            return
        rid = d.wire_rid
        key = self.rng.choice(self.map_keys)
        if self.rng.random() < 0.7:
            delta = self.rng.randint(-20, 20)
            code, body = _http(d.url + "/map/upd", "POST",
                               {"key": key, "delta": delta})
            if code == 200:
                got = json.loads(body)
                seq = self.map_accepted_per_boot.get(rid, 0)
                assert (got["rid"], got["seq"]) == (rid, seq), (
                    f"M1: daemon minted {got['rid']}:{got['seq']}, oracle "
                    f"expected {rid}:{seq}"
                )
                self.map_accepted_per_boot[rid] = seq + 1
                self.map_upds.append((rid, seq, key, delta, int(got["e"])))
                r.map_upds += 1
        else:
            code, body = _http(d.url + "/map/rem", "POST", {"key": key})
            if code == 200:
                got = json.loads(body)
                if got["removed"]:
                    seq = self.map_accepted_per_boot.get(rid, 0)
                    assert (got["rid"], got["seq"]) == (rid, seq), (
                        f"M1: daemon minted {got['rid']}:{got['seq']} for a "
                        f"remove, oracle expected {rid}:{seq}"
                    )
                    self.map_accepted_per_boot[rid] = seq + 1
                    self.map_rems.append((
                        rid, seq, key,
                        {int(w): int(t) for w, t in got["obs"].items()},
                        int(got["e"]),
                    ))
                    r.map_rems += 1

    def _map_pull(self) -> None:
        up = self._running()
        if not up:
            return
        d = self.rng.choice(up)
        peer = self.rng.choice(d.peer_urls)
        code, body = _http(d.url + "/admin/map_pull", "POST", {"peer": peer})
        assert code == 200, f"M3: map pull 500d: {body!r}"
        self.report.map_pulls += json.loads(body)["pulled"]

    def _map_barrier(self) -> None:
        d = self.daemons[0]  # the fleet's single coordinator
        if not d.running:
            return
        # churn gauge: peak retained-record count across reachable daemons
        for dm in self._running():
            code, body = _http(dm.url + "/map/vv")
            if code == 200:
                self.report.map_peak_records = max(
                    self.report.map_peak_records,
                    int(json.loads(body).get("records", 0)),
                )
        code, body = _http(d.url + "/admin/map_barrier", "POST", {})
        assert code == 200, f"M3: map barrier 500d: {body!r}"
        got = json.loads(body)
        if got["status"] == "reset":
            epochs = {str(k): int(e) for k, e in got["epochs"].items()}
            # M2: a minted reset strictly advances every key it touches
            # past any durable holder's epoch
            bar = self._dict_max(self.map_epoch_live.values())
            for k, e in epochs.items():
                assert e > bar.get(k, 0) - 1, (
                    f"M2: epoch regressed at key {k}: {epochs} < "
                    f"holder bar {bar}"
                )
            self._refresh_live()
            self.report.map_barriers += 1
        elif got["status"] == "noop":
            self.report.map_barriers_noop += 1
        else:
            self.report.map_barriers_skipped += 1

    # ---- keyspace actions (K-invariants) ----

    def _ks_write(self) -> None:
        """One tenant-scoped write through the keyspace front door.  The
        response's session-token header carries the minted (rid, seq) —
        per-SHARD seq space, so the oracle records the shard index too."""
        r = self.report
        d = self.rng.choice(self.daemons)
        tenant = self.rng.choice(self.tenants)
        key = self.rng.choice(self.keys)
        val = str(self.rng.randint(-20, 20))
        if not d.running:
            r.ks_rejected += 1
            return
        code, _, hdrs = _http_hdrs(
            d.url + "/data", "POST", {key: val},
            headers={"X-CRDT-Tenant": tenant},
        )
        if code != 200:
            # 502 soft-dead / 429 shed: rejected loudly, never lost-after-
            # accept (I2's bar applies to the keyspace door too)
            r.ks_rejected += 1
            return
        token = json.loads(hdrs["X-CRDT-Session-Token"])
        (got_rid, got_seq), = ((int(k), int(v)) for k, v in token.items())
        shard = self._ks_router.owner_index(self._ks_route_key(tenant, key))
        rid = d.wire_rid
        seq = self.ks_accepted.get((rid, shard), 0)
        assert (got_rid, got_seq) == (rid, seq), (
            f"K1: daemon minted {got_rid}:{got_seq} on shard {shard}, "
            f"oracle expected {rid}:{seq} (routing or seq divergence)"
        )
        self.ks_accepted[(rid, shard)] = seq + 1
        self.ks_ops.append((shard, rid, seq, tenant, key, val))
        r.ks_writes += 1

    def _ks_pull(self) -> None:
        up = self._running()
        if not up:
            return
        d = self.rng.choice(up)
        peer = self.rng.choice(d.peer_urls)
        code, body = _http(d.url + "/admin/ks_pull", "POST", {"peer": peer})
        assert code == 200, f"K3: ks pull 500d: {body!r}"
        self.report.ks_pulls += json.loads(body)["fresh"]

    def _ks_shard_vv(self, d: Daemon, shard: int) -> Optional[Dict[int, int]]:
        code, body = _http(d.url + f"/ks/gossip?shard={shard}")
        if code != 200:
            return None
        return {int(k): int(v) for k, v in json.loads(body)["vv"].items()}

    def _ks_tenant_state(self, d: Daemon, tenant: str):
        code, body, _ = _http_hdrs(d.url + "/data",
                                   headers={"X-CRDT-Tenant": tenant})
        return json.loads(body) if code == 200 else None

    def _pull(self) -> None:
        up = self._running()
        if not up:
            return
        d = self.rng.choice(up)
        peer = self.rng.choice(d.peer_urls)
        code, body = _http(d.url + "/admin/pull", "POST", {"peer": peer})
        assert code == 200, f"I4: pull 500d: {body!r}"  # chain rule etc.
        self.report.pulls += json.loads(body)["pulled"]

    def _barrier(self) -> None:
        d = self.daemons[0]  # the fleet's single coordinator
        if not d.running:
            return
        code, body = _http(d.url + "/admin/barrier", "POST", {})
        assert code == 200, f"I4: barrier 500d: {body!r}"
        if json.loads(body)["frontier"]:
            self.report.barriers += 1
        else:
            self.report.barriers_empty += 1

    def _checkpoint(self) -> None:
        up = self._running()
        if not up:
            return
        d = self.rng.choice(up)
        code, body = _http(d.url + "/admin/checkpoint", "POST", {})
        assert code == 200, f"I4: checkpoint failed: {body!r}"
        # durability bar: everything this boot accepted so far must
        # survive any later crash of this incarnation (KV and set alike —
        # one snapshot covers both sections)
        rid = d.wire_rid
        self.ckpt_watermark[rid] = self.accepted_per_boot.get(rid, 0)
        self.set_ckpt_watermark[rid] = self.set_accepted_per_boot.get(rid, 0)
        self.seq_ckpt_watermark[rid] = self.seq_accepted_per_boot.get(rid, 0)
        self.map_ckpt_watermark[rid] = self.map_accepted_per_boot.get(rid, 0)
        for shard in range(KS_SHARDS):
            self.ks_ckpt_watermark[(rid, shard)] = \
                self.ks_accepted.get((rid, shard), 0)
        # durable-holder bookkeeping: what THIS snapshot would restore
        f = self._query_floor(d, "/set/vv")
        if f is not None:
            self.set_floor_ckpt[d.slot] = f
        f = self._query_floor(d, "/seq/vv")
        if f is not None:
            self.seq_floor_ckpt[d.slot] = f
        e = self._query_floor(d, "/map/vv", field="epochs")
        if e is not None:
            self.map_epoch_ckpt[d.slot] = e
        self.report.checkpoints += 1

    def _soft_toggle(self) -> None:
        up = self._running()
        if not up:
            return
        d = self.rng.choice(up)
        code, _ = _http(d.url + "/ping")
        alive = code == 200
        _http(d.url + f"/condition/{str(not alive).lower()}")
        if alive:
            self.report.soft_kills += 1
        else:
            self.report.soft_revives += 1

    def _sigkill(self) -> None:
        running = [d for d in self.daemons if d.running]
        if len(running) <= 1:
            return  # keep at least one survivor holding the gossip history
        d = self.rng.choice(running)
        d.sigkill()
        # crash reversion: this slot now durably holds only what its last
        # snapshot recorded (nothing, if it never checkpointed)
        self.set_floor_live[d.slot] = dict(
            self.set_floor_ckpt.get(d.slot, {})
        )
        self.seq_floor_live[d.slot] = dict(
            self.seq_floor_ckpt.get(d.slot, {})
        )
        self.map_epoch_live[d.slot] = dict(
            self.map_epoch_ckpt.get(d.slot, {})
        )
        self.report.sigkills += 1

    def _restore(self) -> None:
        dead = [d for d in self.daemons if not d.running]
        if not dead:
            return
        self.rng.choice(dead).spawn()
        self.report.restores += 1

    def step(self) -> None:
        x = self.rng.random()
        if x < 0.13:
            self._write()
        elif x < 0.16:
            self._ks_write()
        elif x < 0.255:
            self._set_write()
        elif x < 0.35:
            self._seq_write()
        elif x < 0.43:
            self._map_write()
        elif x < 0.495:
            self._pull()
        elif x < 0.525:
            self._ks_pull()
        elif x < 0.575:
            self._set_pull()
        elif x < 0.625:
            self._seq_pull()
        elif x < 0.675:
            self._map_pull()
        elif x < 0.72:
            self._barrier()
        elif x < 0.765:
            self._set_barrier()
        elif x < 0.81:
            self._seq_barrier()
        elif x < 0.845:
            self._map_barrier()
        elif x < 0.895:
            self._checkpoint()
        elif x < 0.915:
            self._soft_toggle()
        elif x < 0.955:
            self._sigkill()
        else:
            self._restore()
        self.report.steps += 1

    # ---- heal + invariants ----

    def _states(self) -> List[Optional[Dict[str, str]]]:
        out = []
        for d in self.daemons:
            code, body = _http(d.url + "/data")
            out.append(json.loads(body) if code == 200 else None)
        return out

    def heal_and_check(self, max_rounds: int = 60) -> CrashReport:
        r = self.report
        for d in self.daemons:
            if not d.running:
                d.spawn()
                r.restores += 1
            _http(d.url + "/condition/true")  # clear soft faults
        rounds = 0
        while True:
            states = self._states()
            # convergence = equal STATES and equal VERSION VECTORS: two
            # states can agree by luck while an undelivered delta-0 op is
            # still missing somewhere — vv equality closes that hole
            vvs, set_vvs, set_members = [], [], []
            seq_vvs, seq_items = [], []
            map_views, map_items = [], []
            for d in self.daemons:
                code, body = _http(d.url + "/vv")
                vvs.append(json.loads(body)["vv"] if code == 200 else None)
                code, body = _http(d.url + "/set/vv")
                set_vvs.append(
                    json.loads(body)["vv"] if code == 200 else None
                )
                code, body = _http(d.url + "/set")
                set_members.append(
                    json.loads(body)["members"] if code == 200 else None
                )
                code, body = _http(d.url + "/seq/vv")
                seq_vvs.append(
                    json.loads(body)["vv"] if code == 200 else None
                )
                code, body = _http(d.url + "/seq")
                seq_items.append(
                    json.loads(body)["items"] if code == 200 else None
                )
                code, body = _http(d.url + "/map/vv")
                if code == 200:
                    got = json.loads(body)
                    # vv AND epochs must agree (an undelivered reset is
                    # a divergence items-equality could miss)
                    map_views.append((got["vv"], got["epochs"]))
                else:
                    map_views.append(None)
                code, body = _http(d.url + "/map")
                map_items.append(
                    json.loads(body)["items"] if code == 200 else None
                )
            # keyspace convergence: every SHARD's vv agrees (shard-scoped
            # gossip means per-shard convergence IS fleet convergence) and
            # every tenant's materialized view agrees
            ks_views = []
            for d in self.daemons:
                ks_views.append((
                    [self._ks_shard_vv(d, s) for s in range(KS_SHARDS)],
                    [self._ks_tenant_state(d, t) for t in self.tenants],
                ))
            if (
                all(s is not None for s in states)
                and all(s == states[0] for s in states[1:])
                and all(v == vvs[0] for v in vvs)
                and all(v == set_vvs[0] for v in set_vvs)
                and all(m == set_members[0] for m in set_members)
                and all(v == seq_vvs[0] for v in seq_vvs)
                and all(m == seq_items[0] for m in seq_items)
                and all(v == map_views[0] for v in map_views)
                and all(m == map_items[0] for m in map_items)
                and all(None not in vv_list and None not in st_list
                        for vv_list, st_list in ks_views)
                and all(v == ks_views[0] for v in ks_views)
            ):
                break
            assert rounds < max_rounds, f"liveness violated (I3): {states}"
            for d in self.daemons:
                for peer in d.peer_urls:
                    code, body = _http(d.url + "/admin/pull", "POST",
                                       {"peer": peer})
                    assert code == 200, f"I4: heal pull 500d: {body!r}"
                    code, body = _http(d.url + "/admin/set_pull", "POST",
                                       {"peer": peer})
                    assert code == 200, f"S3: heal set pull 500d: {body!r}"
                    code, body = _http(d.url + "/admin/seq_pull", "POST",
                                       {"peer": peer})
                    assert code == 200, f"Q3: heal seq pull 500d: {body!r}"
                    code, body = _http(d.url + "/admin/map_pull", "POST",
                                       {"peer": peer})
                    assert code == 200, f"M3: heal map pull 500d: {body!r}"
                    code, body = _http(d.url + "/admin/ks_pull", "POST",
                                       {"peer": peer})
                    assert code == 200, f"K3: heal ks pull 500d: {body!r}"
            rounds += 1
        r.rounds_to_converge = rounds

        # the fleet's surviving per-writer prefix
        code, body = _http(self.daemons[0].url + "/vv")
        assert code == 200
        vv = {int(k): int(v) for k, v in json.loads(body)["vv"].items()}

        # I1a: explicitly checkpointed writes survived every crash
        for rid, bar in self.ckpt_watermark.items():
            assert vv.get(rid, -1) >= bar - 1, (
                f"checkpointed writes lost: writer {rid} checkpointed "
                f"{bar} writes but fleet holds only {vv.get(rid, -1) + 1}"
            )
        # I1b: writers whose process was never killed after those writes
        # lost nothing — the CURRENT boot of every slot is alive now
        for d in self.daemons:
            rid = d.wire_rid
            n = self.accepted_per_boot.get(rid, 0)
            assert vv.get(rid, -1) == n - 1, (
                f"live writer {rid} accepted {n} writes, fleet holds "
                f"{vv.get(rid, -1) + 1}"
            )

        # I1c: converged state == fold of exactly the surviving prefix
        sums: Dict[str, int] = {}
        survived = 0
        for rid, seq, cmd in self.ops:
            if seq <= vv.get(rid, -1):
                survived += 1
                for k, v in cmd.items():
                    sums[k] = sums.get(k, 0) + int(v)
        r.ops_lost_to_crashes = len(self.ops) - survived
        want = {k: str(v) for k, v in sums.items()}
        got = self._states()[0]
        assert got == want, (
            f"durability violated (I1): fold of surviving ops has "
            f"{len(want)} keys, cluster has {len(got)}; diff="
            f"{ {k: (want.get(k), got.get(k)) for k in set(want) | set(got) if want.get(k) != got.get(k)} }"
        )
        r.final_keys = len(got)

        # ---- set invariants (S1/S2) over the converged fleet ----
        code, body = _http(self.daemons[0].url + "/set/vv")
        assert code == 200
        got_set = json.loads(body)
        set_vv = {int(k): int(v) for k, v in got_set["vv"].items()}
        set_floor = {int(k): int(v) for k, v in got_set["floor"].items()}

        # S2: the heal-time floor dominates the strongest floor any slot
        # still durably held (memory or snapshot) after crash reversion —
        # a stale-snapshot restore must be absorbed while a durable
        # holder exists; a fleet-wide pre-barrier revert is legitimate
        # (gossip-as-checkpoint; see __init__ note)
        bar = self._dict_max(self.set_floor_live.values())
        for k, v in bar.items():
            assert set_floor.get(k, -1) >= v, (
                f"S2: floor rolled back at writer {k}: {set_floor} < "
                f"holder bar {bar}"
            )

        # S1a/S1b: watermark rules, same shape as I1a/I1b
        for rid, bar in self.set_ckpt_watermark.items():
            assert set_vv.get(rid, -1) >= bar - 1, (
                f"S1a: checkpointed set ops lost: writer {rid} had {bar}, "
                f"fleet holds {set_vv.get(rid, -1) + 1}"
            )
        for d in self.daemons:
            rid = d.wire_rid
            n = self.set_accepted_per_boot.get(rid, 0)
            assert set_vv.get(rid, -1) == n - 1, (
                f"S1b: live set writer {rid} accepted {n}, fleet holds "
                f"{set_vv.get(rid, -1) + 1}"
            )

        # S1c: converged membership == observed-remove fold of exactly the
        # vv-surviving ops (resurrection of a collected tag or a lost
        # removal would both falsify this)
        surviving_adds = [
            (rid, seq, elem) for rid, seq, elem in self.set_adds
            if seq <= set_vv.get(rid, -1)
        ]
        dead_tags = set()
        set_survived = len(surviving_adds)
        for rid, seq, targets in self.set_removes:
            if seq <= set_vv.get(rid, -1):
                set_survived += 1
                dead_tags.update(targets)
        want_members = sorted({
            elem for rid, seq, elem in surviving_adds
            if (rid, seq) not in dead_tags
        })
        r.set_ops_lost = (
            len(self.set_adds) + len(self.set_removes) - set_survived
        )
        code, body = _http(self.daemons[0].url + "/set")
        assert code == 200
        got_members = json.loads(body)["members"]
        assert got_members == want_members, (
            f"S1c: membership diverged from the surviving-op fold: "
            f"fleet={got_members} oracle={want_members}"
        )
        r.final_members = len(got_members)

        # ---- sequence invariants (Q1/Q2) over the converged fleet ----
        code, body = _http(self.daemons[0].url + "/seq/vv")
        assert code == 200
        got_seq = json.loads(body)
        seq_vv = {int(k): int(v) for k, v in got_seq["vv"].items()}
        seq_floor = {int(k): int(v) for k, v in got_seq["floor"].items()}

        # Q2: as S2 — dominance over the durable-holder bar
        bar = self._dict_max(self.seq_floor_live.values())
        for k, v in bar.items():
            assert seq_floor.get(k, -1) >= v, (
                f"Q2: floor rolled back at writer {k}: {seq_floor} < "
                f"holder bar {bar}"
            )

        # Q1a/Q1b: watermark rules
        for rid, bar in self.seq_ckpt_watermark.items():
            assert seq_vv.get(rid, -1) >= bar - 1, (
                f"Q1a: checkpointed seq ops lost: writer {rid} had {bar}, "
                f"fleet holds {seq_vv.get(rid, -1) + 1}"
            )
        for d in self.daemons:
            rid = d.wire_rid
            n = self.seq_accepted_per_boot.get(rid, 0)
            assert seq_vv.get(rid, -1) == n - 1, (
                f"Q1b: live seq writer {rid} accepted {n}, fleet holds "
                f"{seq_vv.get(rid, -1) + 1}"
            )

        # Q1c: converged membership == targeted-remove fold of exactly
        # the vv-surviving seq ops (order agreement is enforced by the
        # convergence loop: every daemon rendered the identical list)
        surviving_ins = [
            (rid, seq, elem) for rid, seq, elem in self.seq_inserts
            if seq <= seq_vv.get(rid, -1)
        ]
        dead_idents = set()
        seq_survived = len(surviving_ins)
        for rid, seq, target in self.seq_removes:
            if seq <= seq_vv.get(rid, -1):
                seq_survived += 1
                dead_idents.add(target)
        want_items = sorted(
            elem for rid, seq, elem in surviving_ins
            if (rid, seq) not in dead_idents
        )
        r.seq_ops_lost = (
            len(self.seq_inserts) + len(self.seq_removes) - seq_survived
        )
        code, body = _http(self.daemons[0].url + "/seq")
        assert code == 200
        got_items = json.loads(body)["items"]
        assert sorted(got_items) == want_items, (
            f"Q1c: sequence content diverged from the surviving-op fold: "
            f"fleet={sorted(got_items)} oracle={want_items}"
        )
        r.final_len = len(got_items)

        # ---- map invariants (M1/M2) over the converged fleet ----
        code, body = _http(self.daemons[0].url + "/map/vv")
        assert code == 200
        got_map = json.loads(body)
        map_vv = {int(k): int(v) for k, v in got_map["vv"].items()}
        map_epochs = {str(k): int(e) for k, e in got_map["epochs"].items()}

        # M2: as S2/Q2 — heal-time epochs dominate the durable-holder bar
        bar = self._dict_max(self.map_epoch_live.values())
        for k, e in bar.items():
            assert map_epochs.get(k, 0) >= e, (
                f"M2: epoch rolled back at key {k}: {map_epochs} < "
                f"holder bar {bar}"
            )

        # M1a/M1b: watermark rules, same shape as I1a/I1b (the vv covers
        # dominated-and-pruned ops too — they were SEEN, then voided)
        for rid, bar in self.map_ckpt_watermark.items():
            assert map_vv.get(rid, -1) >= bar - 1, (
                f"M1a: checkpointed map ops lost: writer {rid} had {bar}, "
                f"fleet holds {map_vv.get(rid, -1) + 1}"
            )
        for d in self.daemons:
            rid = d.wire_rid
            n = self.map_accepted_per_boot.get(rid, 0)
            assert map_vv.get(rid, -1) == n - 1, (
                f"M1b: live map writer {rid} accepted {n}, fleet holds "
                f"{map_vv.get(rid, -1) + 1}"
            )

        # M1c: converged {key: value} == the epoch-filtered observed-
        # remove PN fold of exactly the vv-surviving ops.  Reset-wins:
        # an op whose mint epoch is below the key's final epoch is void.
        map_survived = 0
        per_key: Dict[str, Dict] = {}
        for rid, seq, key, delta, e in self.map_upds:
            if seq <= map_vv.get(rid, -1):
                map_survived += 1
                if e == map_epochs.get(key, 0):
                    pk = per_key.setdefault(
                        key, {"cnt": {}, "obs": {}, "val": 0}
                    )
                    pk["cnt"][rid] = pk["cnt"].get(rid, 0) + 1
                    pk["val"] += delta
        for rid, seq, key, obs, e in self.map_rems:
            if seq <= map_vv.get(rid, -1):
                map_survived += 1
                if e == map_epochs.get(key, 0):
                    pk = per_key.setdefault(
                        key, {"cnt": {}, "obs": {}, "val": 0}
                    )
                    for w, t in obs.items():
                        pk["obs"][w] = max(pk["obs"].get(w, -1), t)
        want_map = {}
        for key, pk in per_key.items():
            contained = any(
                cnt >= 1 and (cnt - 1) > pk["obs"].get(w, -1)
                for w, cnt in pk["cnt"].items()
            )
            if contained:
                want_map[key] = pk["val"]
        r.map_ops_lost = (
            len(self.map_upds) + len(self.map_rems) - map_survived
        )
        code, body = _http(self.daemons[0].url + "/map")
        assert code == 200
        got_map_items = json.loads(body)["items"]
        assert got_map_items == want_map, (
            f"M1c: map content diverged from the epoch-filtered "
            f"surviving-op fold: fleet={got_map_items} oracle={want_map}"
        )
        r.final_map_keys = len(got_map_items)

        # ---- keyspace invariants (K1) over the converged fleet ----
        # Same shape as I1, but per SHARD: seq spaces collide across
        # shards by design, so watermark and fold rules are (rid, shard)-
        # scoped.  The shard snapshots rode the same manifest as the main
        # plane, so K1a is the satellite's "per-shard sections restore
        # verified" claim checked end-to-end, not just at the file layer.
        ks_vvs = [self._ks_shard_vv(self.daemons[0], s)
                  for s in range(KS_SHARDS)]
        assert all(vv is not None for vv in ks_vvs)
        # K1a: explicitly checkpointed keyspace writes survived
        for (rid, shard), bar in self.ks_ckpt_watermark.items():
            assert ks_vvs[shard].get(rid, -1) >= bar - 1, (
                f"K1a: checkpointed ks ops lost: writer {rid} shard "
                f"{shard} had {bar}, fleet holds "
                f"{ks_vvs[shard].get(rid, -1) + 1}"
            )
        # K1b: writers never killed after their writes lost nothing
        for d in self.daemons:
            rid = d.wire_rid
            for shard in range(KS_SHARDS):
                n = self.ks_accepted.get((rid, shard), 0)
                assert ks_vvs[shard].get(rid, -1) == n - 1, (
                    f"K1b: live ks writer {rid} shard {shard} accepted "
                    f"{n}, fleet holds {ks_vvs[shard].get(rid, -1) + 1}"
                )
        # K1c: every tenant's converged view == the sum fold of exactly
        # the vv-surviving tenant ops
        ks_survived = 0
        tenant_sums: Dict[str, Dict[str, int]] = {t: {} for t in self.tenants}
        for shard, rid, seq, tenant, key, val in self.ks_ops:
            if seq <= ks_vvs[shard].get(rid, -1):
                ks_survived += 1
                sums = tenant_sums[tenant]
                sums[key] = sums.get(key, 0) + int(val)
        r.ks_ops_lost = len(self.ks_ops) - ks_survived
        for tenant in self.tenants:
            want_t = {k: str(v) for k, v in tenant_sums[tenant].items()}
            got_t = self._ks_tenant_state(self.daemons[0], tenant)
            assert got_t == want_t, (
                f"K1c: tenant {tenant} diverged from the surviving-op "
                f"fold: fleet={got_t} oracle={want_t}"
            )
            r.final_ks_keys += len(want_t)

        # forensic black box (crdt_tpu_torch.obs.events): every slot's JSONL must
        # have recorded the run — one boot line per incarnation (SIGKILLed
        # boots included: the line is flushed at spawn), so a silent
        # event-log regression fails the soak, not just the post-mortem.
        from crdt_tpu_torch.obs.events import read_jsonl

        for d in self.daemons:
            recs = read_jsonl(d.event_log_path)
            r.event_lines += len(recs)
            boots = sum(1 for e in recs if e.get("event") == "boot")
            assert boots == d.boots, (
                f"black box: slot {d.slot} logged {boots} boot events "
                f"across {d.boots} boots (event log lost writes?)"
            )
            r.event_boots += boots
            # recovery provenance (crdt_tpu_torch.utils.checkpoint): every
            # restored boot must be backed by exactly one snapshot_restore
            # event, and on this soak's UNDAMAGED disks the restore must
            # have come from the manifest-verified LATEST target — any
            # quarantine or generation fallback here means the checkpoint
            # layer corrupted its own snapshots
            restored_boots = sum(
                1 for e in recs
                if e.get("event") == "boot" and e.get("restored")
            )
            restores = [e for e in recs
                        if e.get("event") == "snapshot_restore"]
            assert len(restores) == restored_boots, (
                f"black box: slot {d.slot} logged {len(restores)} "
                f"snapshot_restore events for {restored_boots} restored "
                "boots (recovery provenance lost)"
            )
            assert all(e.get("verified") and not e.get("fallback")
                       for e in restores), (
                f"black box: slot {d.slot} restored from an unverified or "
                f"fallback snapshot on an undamaged disk: {restores}"
            )
            # every snapshot in this soak was written WITH the keyspace
            # tier, so every verified restore must have carried all of
            # its per-shard sections (a restore that silently skipped
            # them would still pass the manifest check)
            assert all(e.get("ks_shards") == KS_SHARDS for e in restores), (
                f"black box: slot {d.slot} restored snapshots missing "
                f"keyspace shard sections: {restores}"
            )
            quarantines = [e for e in recs if e.get("event") in
                           ("snapshot_quarantine", "payload_quarantine")]
            assert not quarantines, (
                f"black box: slot {d.slot} quarantined state during a "
                f"fault-free-disk soak: {quarantines}"
            )
        return r

    def close(self) -> None:
        for d in self.daemons:
            d.shutdown()
        if self._tmp is not None:
            self._tmp.cleanup()

    def write_postmortem(self) -> Optional[str]:
        """Bundle every daemon's JSONL black box into
        postmortem-<seed>.tar.gz (no fault log — this soak's only nemesis
        is SIGKILL; the boot/restore provenance is in the events).  Must
        run BEFORE close(): the logs live in the soak's temp dir."""
        if self.postmortem_dir is None:
            return None
        from crdt_tpu_torch.obs import assemble

        out = str(pathlib.Path(self.postmortem_dir)
                  / f"postmortem-{self.seed}.tar.gz")
        try:
            assemble.write_postmortem(
                out, [d.event_log_path for d in self.daemons])
        except OSError as e:
            print(f"[crashsoak] postmortem bundling failed: {e}")
            return None
        print(f"[crashsoak] postmortem bundle: {out}")
        return out

    def run(self, n_steps: int) -> CrashReport:
        try:
            for _ in range(n_steps):
                self.step()
            return self.heal_and_check()
        except AssertionError:
            self.write_postmortem()
            raise
        finally:
            self.close()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.harness.crashsoak",
        description="crash-recovery soak")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--postmortem-dir", default=".",
                    help="where postmortem-<seed>.tar.gz lands on failure")
    ap.add_argument("--device", default=None,
                    help="every daemon's torch device (default: the CUDA "
                         "card; the command exits 2 without one rather "
                         "than fall back; cpu is for the tests)")
    args = ap.parse_args(argv)
    try:
        device = str(default_device(args.device))
    except RuntimeError as e:
        print(f"crashsoak: {e}", file=sys.stderr)
        return 2
    for seed in range(args.seeds):
        runner = CrashSoakRunner(n=args.replicas, seed=seed,
                                 postmortem_dir=args.postmortem_dir,
                                 device=device)
        print(f"seed {seed}: {runner.run(args.steps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
