"""Nemesis soak — the jepsen-lite composition harness of the fault plane
(own copy of ``crdt_tpu.harness.nemesis_soak``, every mode).

Drives an IN-PROCESS NodeHost fleet on one torch device (``device=None``:
the CUDA card, and the soak raises without one; the tests pass
``"cpu"``), HTTP servers up and gossip loops off (every round is driven
explicitly, single-threaded), through a seeded
:class:`crdt_tpu_torch.faults.NemesisSchedule`: asymmetric partitions, dropped
/ delayed / duplicated / reordered / truncated / corrupted deliveries,
crashes + incarnation-bumped reboots, torn snapshot writes, fsync stalls,
and clock skew — then heals and asserts the CRDT laws held:

* **convergence-after-heal** — every node reaches the SAME materialized
  state and version vector within a bounded number of pull rounds once
  the nemesis stops;
* **prefix oracle** — the converged state contains EXACTLY the per-writer
  contiguous prefix the fleet's vv claims, keyed against the driver's own
  write ledger (no loss under the vv, no ghosts above it);
* **duplicate / reorder idempotence** — after convergence, re-applying a
  full payload twice and an older delta after it leaves state and vv
  byte-identical (the state-based join laws, PAPERS.md);
* **recovery provenance** — a deliberately planted corrupt snapshot is
  quarantined (``snapshot_quarantine`` in the JSONL black box) and the
  node restores from the PREVIOUS generation (``snapshot_restore`` with
  ``fallback=true``); every wire-corruption that reached a node shows up
  as a ``payload_quarantine`` event — degradation, never a dead loop;
* **stability-GC safety** (``--gc``) — the coordinator drives
  fleet-coordinated op-log GC from the piggybacked stability frontier
  (crdt_tpu_torch.consistency) on a fixed cadence OUTSIDE the action rng, so a
  SHADOW arm with GC disabled replays the identical action + fault
  stream: the converged state and vv must be BIT-EQUAL between arms while
  the GC arm retains strictly fewer raw commands.  Every mint is audited
  against the tracker's ledger (frontier under every member's vouched
  summary, summaries under the running-max true vv the driver recorded)
  and after every round no op above a node's adopted frontier may be
  missing from its raw command map — collected means strictly below;
* **multitenant isolation** (``--multitenant``) — the sharded keyspace
  tier (crdt_tpu_torch.keyspace) rides the soak: every write names a tenant,
  routes by rendezvous hash to one of 4 plane shards, and keys are drawn
  from a simulated million-key universe.  One NOISY tenant holds a tiny
  quota slice and keeps bursting past it (plus corrupt pages); the soak
  asserts per-tenant isolation 1:1 in the ledger — every quota shed and
  page quarantine the noisy client saw appears tenant-labeled in some
  node's black box (and ONLY the noisy tenant ever sheds), while every
  other tenant's converged view is bit-exact against the driver's
  admission ledger on every node.  Shard-scoped anti-entropy
  (/ks/gossip) crosses the same fault plane as KV gossip; after heal a
  shard-local stability GC must empty every shard's op log on every
  node.  Keyspace shards checkpoint and restore like every other plane
  (utils/checkpoint ks-shard-*.json + the reshard ledger), so durable
  crashes and incarnation-bumped reboots ride this arm too — every
  reboot must come back as a verified, non-fallback restore carrying
  the shard files (``_check_mt_restores``);
* **online resharding** (``--reshard``, implies ``--multitenant``) —
  the epoch-fenced live S -> S' migration (crdt_tpu_torch.keyspace.reshard)
  runs INSIDE the fault schedule: mid-soak every node opens the
  MIGRATE window toward the target shard map, migration slices stream
  over /ks/migrate through corrupt + drop windows aimed at exactly
  that surface, a durable crash lands mid-window and its reboot must
  RESUME the window from the persisted reshard ledger, and the
  cutover is deliberately STAGGERED so stale-epoch pulls bounce off
  the 409 fence.  After heal the fleet must hold one epoch and one
  shard map, post-cutover ownership must be disjoint (no key at two
  shards), per-tenant views must equal the admission ledger across
  S -> S', and every fence and migration quarantine reconciles 1:1
  against the driver's predictions (``_check_reshard_oracle``);
* **divergence audit** (``--audit``) — the live audit plane
  (crdt_tpu_torch.obs.audit) rides the default action table under fire: the
  coordinator mints stability frontiers on the --gc cadence (digests
  only compare at non-empty frontiers), every node's watchdog ticks
  once per step, and the schedule carries ``flip`` rules on the
  ``op="state"`` pseudo-edge — when one fires, the driver silently
  flips a committed row's winner timestamp post-merge
  (``plant_divergence``) and convicts it SYNCHRONOUSLY via the
  watchdog's store scrub, so ``audit_scrub_drift`` events reconcile
  1:1 against the planted-flip fault records.  The corruption is
  pinned into a durable generation (and audit crashes are durable),
  so no fallback restore can un-plant it; after heal, the
  frontier-anchored digest comparison must raise
  ``divergence_detected`` implicating EXACTLY the planted nodes, with
  an auto-postmortem bundle on disk.  ``run_soak`` replays a
  plant-free arm of the same seed: it must stay divergence-silent
  (zero false positives under the full fault schedule) and its per-op
  wire-call census must equal the planted arm's exactly — digests and
  convictions piggyback on existing exchanges, zero new round trips;
* **strong never-stale** (``--strong``) — a ``strong_op`` action mixes
  linearizable reads and CAS (crdt_tpu_torch.consistency.plane) into the fault
  schedule.  Node clocks are re-pinned each step into disjoint ms bands
  (one shared wall sample), so LWW order == mint order and the audit is
  exact: a linearizable read may return ONLY the last quorum-committed
  value or a still-outstanding indeterminate write — never anything
  older.  Every client-caught ConsistencyUnavailable must match a
  ``consistency_unavailable`` event 1:1 (down to the indeterminate
  flag), and after heal both a linearizable read and a CAS must succeed
  outright.

Determinism: the fault log records step indices only (no wall clock, no
URLs); circuit breakers run on a step-indexed clock and per-edge seeded
jitter.  Two same-seed runs therefore produce BYTE-IDENTICAL fault logs
— ``--replay-check`` pins exactly that, and a failing seed replays from
nothing but its number.

The same seed gives the same fault-log bytes, write ledger, converged
state, vv, wire-call census and report counters in both packages.
``--race-check`` runs the fleet under the witnessed-race detector
(:mod:`crdt_tpu_torch.analysis.verify.race`), installed before the fleet
is built, and fails on any witness or on a run that touched no watched
attribute.  The JAX package also maps each witness to its static
lock-discipline findings (crdtflow); that cross-check comes with the lint
tiers (ROADMAP Queue 1 item 8).  ``--ks-mesh on`` folds the keyspace's
shards through the mesh plane (:mod:`crdt_tpu_torch.parallel.meshplane`).

    python -m crdt_tpu_torch.harness.nemesis_soak --nodes 3 --steps 120 --device cuda
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import random
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from crdt_tpu_torch import default_device
from crdt_tpu_torch.faults import (
    FaultPlane,
    FaultyDisk,
    FaultyTransport,
    NemesisSchedule,
    plant_corruption,
)
from crdt_tpu_torch.harness.crashsoak import RID_STRIDE, _free_ports
from crdt_tpu_torch.obs import assemble, health
from crdt_tpu_torch.obs.events import read_jsonl
from crdt_tpu_torch.obs.provenance import BirthLedger, propagation_summary
from crdt_tpu_torch.utils.config import ClusterConfig

# --strong clock pinning: every node runs a _BandClock whose now_ms lands
# in the current step's private band [(step+1)*_TS_PIN_MS, ...), so ts
# order == mint-step order — which is what makes the never-stale audit
# exact: LWW can never resurrect an op minted in an earlier step over one
# minted later.  ~300 steps * 2^20 ms stays well inside the int32 ms range
# the oplog stores.
_TS_PIN_MS = 1 << 20


class _BandClock:
    """HostClock stand-in for --strong: ``now_ms`` is banded per step while
    ``epoch_ms`` stays a CONSTANT zero, shared by every node.

    The constant epoch is the load-bearing part.  Mutating ``epoch_ms``
    per step (the obvious way to band now_ms) silently re-times every op
    already encoded: wire keys carry ABSOLUTE timestamps (``rel +
    epoch``), a node's wire bytes may be cached pre-encoded, and receivers
    rebase with THEIR current epoch — so any epoch drift between encode
    time and decode time shifts the op's stored timestamp on the receiving
    node only, and the fleet's LWW winners diverge unrecoverably (dedup by
    (rid, seq) means the damage is never repaired).  With epoch pinned at
    zero on every node, abs == rel everywhere and every conversion —
    cached, delayed, or redelivered — round-trips exactly."""

    def __init__(self, band: int = 0):
        self.epoch_ms = 0
        self.band = int(band)
        self._wall0 = int(time.time() * 1000)

    def now_ms(self) -> int:
        # real ms elapsed inside the run is tiny against the band width;
        # the clamp keeps a pathologically slow run inside its band
        off = int(time.time() * 1000) - self._wall0
        return (self.band + 1) * _TS_PIN_MS + min(off, _TS_PIN_MS - 1)


class _PlaneTime:
    """Deterministic fake time for a consistency plane under the nemesis:
    now() advances only through sleep(), so the plane's wait/poll loops
    issue a replayable number of wire calls regardless of host speed —
    the fault log stays byte-identical across same-seed runs."""

    def __init__(self):
        self._lock = threading.Lock()
        self.t = 0.0

    def now(self) -> float:
        with self._lock:
            return self.t

    def sleep(self, s: float) -> None:
        with self._lock:
            self.t += s


@dataclasses.dataclass
class NemesisReport:
    seed: int
    steps: int
    nodes: int
    writes: int = 0
    pulls: int = 0
    merges: int = 0
    backoff_skips: int = 0
    checkpoints: int = 0
    torn_writes: int = 0
    crashes: int = 0
    reboots: int = 0
    barriers: int = 0
    heal_rounds: int = 0
    fault_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    payload_quarantines: int = 0
    snapshot_quarantines: int = 0
    sheds: int = 0
    shed_ops: int = 0
    page_quarantines: int = 0
    final_keys: int = 0
    composite_ops: int = 0
    final_composite_keys: int = 0
    propagation: Dict[str, float] = dataclasses.field(default_factory=dict)
    blame_coverage: Optional[float] = None
    # --gc arm accounting + the two-arm comparison inputs (state_json /
    # final_vv / writes_ledger are captured on EVERY run so the GC-off
    # shadow arm can be compared bit-for-bit; not printed in summary())
    gc_mints: int = 0
    gc_skips: int = 0
    gc_retained: Optional[int] = None
    gc_retained_shadow: Optional[int] = None
    state_json: Optional[str] = None
    final_vv: Optional[Dict[int, int]] = None
    writes_ledger: Optional[Dict[int, int]] = None
    # --strong accounting (client-side counts; audited 1:1 vs events)
    strong_ok: int = 0
    strong_unavailable: int = 0
    strong_conflicts: int = 0
    strong_indeterminate: int = 0
    # --crash-coordinator accounting (rides --strong): leaseholder kills
    # mid-CAS, zombie pushes refused by fence, and the fence-decision
    # audit inputs (cas_commit / cas_fenced_reject event totals)
    coordinator_crashes: int = 0
    zombie_attempts: int = 0
    cas_commits: int = 0
    fenced_rejects: int = 0
    # --multitenant accounting (client-side; audited 1:1 vs tenant-
    # labeled events — the per-tenant never-silent contract)
    mt_tenants: int = 0
    mt_shards: int = 0
    mt_keys: int = 0
    mt_sheds: int = 0
    mt_shed_ops: int = 0
    mt_page_quarantines: int = 0
    # fleet SLO rollup accounting (obs/fleet): per-tenant propagation
    # coverage from the tenant-labeled flight-recorder series, and the
    # slo_breach events the rollup recorded (reconciled 1:1 vs the
    # ingest_shed provenance)
    mt_prop_coverage: Optional[Dict[str, float]] = None
    slo_breaches: int = 0
    # --multitenant crash accounting: verified non-fallback restores
    mt_restores: int = 0
    # --reshard accounting (rides --multitenant): the online S -> S'
    # migration driven mid-soak; fences and slice quarantines are
    # reconciled 1:1 against the ks_reshard_* black-box events
    rs_epoch: int = 0
    rs_shards_from: int = 0
    rs_shards_to: int = 0
    rs_streams: int = 0
    rs_fences: int = 0
    rs_quarantines: int = 0
    # --audit accounting: planted silent corruptions (fault plane op
    # "state"), their 1:1 scrub convictions, the divergence events the
    # frontier-anchored comparison raised, auto-postmortem bundles, and
    # the per-op decide() census the zero-new-round-trips pin compares
    # against the plant-free arm
    audit_planted: int = 0
    audit_drifts: int = 0
    audit_divergences: int = 0
    audit_postmortems: int = 0
    wire_census: Optional[Dict[str, int]] = None

    def summary(self) -> str:
        faults = ", ".join(
            f"{k}={v}" for k, v in sorted(self.fault_counts.items())
        )
        prop = ""
        if self.propagation:
            prop = (
                f"; propagation p50/p99 = "
                f"{self.propagation.get('propagation_steps_p50')}/"
                f"{self.propagation.get('propagation_steps_p99')} steps "
                f"over {self.propagation.get('propagation_steps_count')} "
                f"visibilities"
            )
        if self.blame_coverage is not None:
            prop += f"; blame coverage {self.blame_coverage:.3f}"
        if self.composite_ops:
            prop += (f"; composite: {self.composite_ops} ops -> "
                     f"{self.final_composite_keys} keys")
        if self.sheds:
            prop += (f"; overload: {self.sheds} sheds "
                     f"({self.shed_ops} ops turned away), "
                     f"{self.page_quarantines} corrupt pages quarantined, "
                     f"provenance 1:1")
        if self.gc_mints or self.gc_skips:
            prop += (f"; gc: {self.gc_mints} mints / {self.gc_skips} "
                     f"stalled rounds, {self.gc_retained} raw commands "
                     f"retained")
            if self.gc_retained_shadow is not None:
                prop += (f" vs {self.gc_retained_shadow} without GC "
                         f"(bit-equal states)")
        if self.mt_tenants:
            prop += (f"; multitenant: {self.mt_tenants} tenants x "
                     f"{self.mt_shards} shards -> {self.mt_keys} keys, "
                     f"noisy: {self.mt_sheds} quota sheds "
                     f"({self.mt_shed_ops} ops), "
                     f"{self.mt_page_quarantines} corrupt pages, "
                     f"provenance 1:1; ks gc emptied every shard log")
        if self.mt_restores:
            prop += (f"; {self.mt_restores} verified crash restore(s), "
                     f"never a fallback")
        if self.rs_shards_to:
            prop += (f"; reshard: {self.rs_shards_from}->"
                     f"{self.rs_shards_to} shards at epoch "
                     f"{self.rs_epoch}, {self.rs_streams} slices "
                     f"streamed, {self.rs_fences} stale-epoch 409(s) + "
                     f"{self.rs_quarantines} corrupt-slice "
                     f"quarantine(s) reconciled 1:1")
        if self.mt_prop_coverage:
            worst = min(self.mt_prop_coverage.values())
            prop += (f"; per-tenant propagation coverage >= {worst:.2%} "
                     f"({len(self.mt_prop_coverage)} tenants), "
                     f"{self.slo_breaches} slo_breach event(s) reconciled")
        if self.strong_ok or self.strong_unavailable:
            prop += (f"; strong: {self.strong_ok} ok, "
                     f"{self.strong_unavailable} unavailable (1:1 events, "
                     f"{self.strong_indeterminate} indeterminate), "
                     f"{self.strong_conflicts} cas conflicts, never stale")
        if self.audit_planted or self.audit_divergences:
            prop += (f"; audit: {self.audit_planted} planted flip(s) -> "
                     f"{self.audit_drifts} scrub conviction(s), "
                     f"{self.audit_divergences} divergence event(s), "
                     f"{self.audit_postmortems} auto-postmortem(s)")
        elif self.wire_census is not None:
            prop += "; audit: clean arm, 0 divergence events"
        if self.coordinator_crashes or self.zombie_attempts:
            prop += (f"; coordinator: {self.coordinator_crashes} "
                     f"leaseholder crashes, {self.zombie_attempts} zombie "
                     f"pushes fenced off, {self.cas_commits} fenced "
                     f"commits / {self.fenced_rejects} rejects "
                     f"(<=1 decider per (slot, fence))")
        return (
            f"seed {self.seed}: {self.steps} steps x {self.nodes} nodes — "
            f"{self.writes} writes, {self.pulls} pulls ({self.merges} "
            f"merged, {self.backoff_skips} breaker-skipped), "
            f"{self.crashes} crashes / {self.reboots} reboots, "
            f"{self.checkpoints} checkpoints ({self.torn_writes} torn), "
            f"{self.barriers} barriers; faults: [{faults}]; quarantines: "
            f"{self.payload_quarantines} payload / "
            f"{self.snapshot_quarantines} snapshot; converged in "
            f"{self.heal_rounds} heal rounds to {self.final_keys} keys"
            f"{prop}"
        )


class _Slot:
    """One replica slot: a stable port + checkpoint dir across an
    in-process NodeHost per boot (the nemesis analogue of crashsoak's
    subprocess Daemon)."""

    def __init__(self, soak: "NemesisSoak", slot: int, port: int,
                 peer_slots: List[int], peer_ports: List[int]):
        self.soak = soak
        self.slot = slot
        self.port = port
        self.peer_slots = peer_slots
        self.peer_urls = [f"http://127.0.0.1:{p}" for p in peer_ports]
        self.ckpt_dir = str(pathlib.Path(soak.root) / f"node{slot}")
        self.disk = FaultyDisk(soak.plane, str(slot))
        self.boots = 0
        self.host = None
        self.transports: Dict[int, FaultyTransport] = {}
        # strong mode: this incarnation's fake plane clock — the lease
        # scenarios steer it directly (expiry, zombie skew)
        self.plane_time: Optional[_PlaneTime] = None

    @property
    def event_log_path(self) -> str:
        return str(pathlib.Path(self.ckpt_dir) / "events.jsonl")

    @property
    def alive(self) -> bool:
        return self.host is not None

    def boot(self) -> None:
        from crdt_tpu_torch.api.net import NodeHost
        from crdt_tpu_torch.utils import checkpoint as ckpt

        assert self.host is None
        if self.soak.overload:
            # fresh builder per boot: the front door's per-origin page
            # watermark also resets with the new host, so page_seq 0 is
            # genuinely new again (origin = slot index, stable)
            from crdt_tpu_torch.ingest import PageBuilder
            self.pager = PageBuilder(origin=self.slot, page_size=1 << 20)
        inc = ckpt.bump_incarnation(self.ckpt_dir)
        rid = self.slot + RID_STRIDE * inc
        self.boots += 1
        plane = self.soak.plane
        self.host = NodeHost(
            rid=rid, peers=self.peer_urls, port=self.port,
            device=self.soak.device,
            config=self.soak.config, coordinator=(self.slot == 0),
            checkpoint_dir=self.ckpt_dir,
            event_log=self.event_log_path,
            # flight recorder time base: the plane's step IS the soak's
            # deterministic clock, and the ledger is fleet-shared, so
            # propagation-steps lag lines up exactly with the fault log
            step_clock=lambda: int(plane.step),
            birth_ledger=self.soak.ledger,
            # keyspace shards get their own fleet-shared per-shard
            # ledgers (None outside --multitenant): tenant-labeled
            # propagation lag with the same exactly-once derivation
            ks_birth_ledgers=self.soak.ks_ledgers,
        )
        # swap the agent's peer clients for fault-plane shims: every wire
        # interaction of the runtime under test now crosses the nemesis.
        # Breakers run on the plane's STEP clock and per-edge seeded
        # jitter so backoff windows replay identically under one seed.
        self.transports = {
            j: FaultyTransport(
                url, plane, src=str(self.slot), dst=str(j),
                timeout=2.0, backoff_base_s=1.0, backoff_cap_s=5.0,
                rng=random.Random(
                    f"nemesis-breaker:{self.soak.seed}:{self.slot}:{j}"
                ),
                clock=lambda: float(plane.step),
            )
            for j, url in zip(self.peer_slots, self.peer_urls)
        }
        self.host.agent.peers = list(self.transports.values())
        ident = self.soak.member_ident
        self.host.leases.member_key = lambda u: ident.get(u, u)
        if self.soak.gc or self.soak.strong or self.soak.audit:
            # the stability tracker's staleness windows age in plane
            # steps (same time base as the breakers), and the consistency
            # plane's wait loops run on fake seconds that advance only
            # through sleep() — both replay identically under one seed
            self.host.agent.stability.clock = lambda: float(plane.step)
            ft = _PlaneTime()
            self.plane_time = ft
            self.host.consistency.clock = ft.now
            self.host.consistency.sleep = ft.sleep
            # the lease table ages on the same fake clock, so expiry and
            # zombie-skew scenarios are driven by the soak, not wall time
            self.host.leases.clock = ft.now
        if self.soak.strong:
            # banded mint timestamps over a constant zero epoch — installed
            # after NodeHost restore (which re-applies the snapshot's
            # epoch_ms, also zero for every strong incarnation) and before
            # the server takes traffic
            self.host.node.clock = _BandClock(band=int(plane.step))
        self.host.start_server()

    def crash(self, durable: Optional[bool] = None) -> None:
        """SIGKILL analogue: the server vanishes mid-conversation; no stop
        event, no final checkpoint — un-gossiped, un-snapshotted writes of
        this incarnation die with it.

        Strong mode crashes fail-STOP, not fail-amnesia: a quorum ack
        promises the op is on stable storage, so the never-stale audit is
        only sound if acked state survives the crash.  Audit-mode crashes
        are durable for the mirror reason: an amnesia reboot can regress
        a vv below an already-minted frontier, and the wire-summary
        adoption that follows would heal or spread the planted corruption
        mid-run, voiding the 1:1 divergence accounting.  The flush is a
        direct atomic save (no FaultyDisk tearing — a torn fsync'd ack is
        a different fault model).  ``durable=False`` keeps the amnesia
        crash for the plant-and-recover scenario, whose fallback restore
        deliberately drops a never-acked, never-gossiped write."""
        assert self.host is not None
        if ((self.soak.strong or self.soak.audit)
                if durable is None else durable):
            from crdt_tpu_torch.utils import checkpoint as ckpt

            h = self.host
            ckpt.save_node_atomic(
                self.ckpt_dir, h.node, set_node=h.set_node,
                seq_node=h.seq_node, map_node=h.map_node,
                composite_node=h.composite_node,
                keyspace=h.keyspace, leases=h.leases,
            )
        self.host.stop_server()
        self.host.node.events.close()
        self.host = None
        self.transports = {}


class NemesisSoak:
    #: composite-mode key pool: small on purpose — contention on shared
    #: keys is what exercises concurrent upd/rem token races
    COMPOSITE_KEYS = ("alpha", "beta", "gamma", "delta")
    #: strong-mode register pool: shared across all coordinators so CAS
    #: conflicts and cross-node read-after-CAS actually happen
    STRONG_KEYS = ("reg-a", "reg-b", "reg-c")
    #: multitenant mode: well-behaved tenants (no quota slice — they ride
    #: the lane mark and must NEVER shed) plus one noisy tenant whose
    #: tiny quota slice the soak keeps bursting past
    MT_TENANTS = ("t-acme", "t-bolt", "t-crab")
    MT_NOISY = "t-noisy"
    MT_NOISY_QUOTA = 8
    MT_SHARDS = 4
    #: simulated key universe: indices walk the million-key space with a
    #: coprime stride, so every draw is unique (no cross-node LWW ties)
    #: while keys scatter over the whole routable range
    MT_UNIVERSE = 1_000_000
    MT_STRIDE = 999_983
    #: --gc drives one coordinated GC attempt every this many steps —
    #: OUTSIDE the action rng, so the GC-off shadow arm replays the
    #: identical action stream
    GC_EVERY = 5

    def __init__(self, seed: int, nodes: int = 3, steps: int = 120,
                 fault_log: Optional[str] = None,
                 postmortem_dir: Optional[str] = None,
                 assemble_check: bool = False,
                 composite: bool = False,
                 overload: bool = False,
                 gc: bool = False,
                 strong: bool = False,
                 crash_coordinator: bool = False,
                 multitenant: bool = False,
                 reshard: bool = False,
                 ks_mesh: str = "auto",
                 audit: bool = False,
                 audit_plant: bool = True,
                 device=None):
        # resolved before anything boots: no card and no explicit device
        # raises here
        self.device = default_device(device)
        # --reshard rides the multitenant action table: the tenant
        # admission ledger IS the zero-lost-ops oracle across S -> S'
        multitenant = multitenant or reshard
        assert nodes >= 2, "nemesis needs a fleet (>= 2 nodes)"
        assert not reshard or nodes >= 3, (
            "--reshard staggers the cutover across a mid-window crash: "
            "needs >= 3 nodes"
        )
        assert not reshard or steps >= 30, (
            "--reshard needs a horizon wide enough for the three-phase "
            "window (>= 30 steps)"
        )
        assert strong or not crash_coordinator, (
            "--crash-coordinator targets the lease plane --strong drives; "
            "enable --strong (main() implies it for you)"
        )
        assert not (strong and overload), (
            "--strong and --overload use disjoint action tables; run them "
            "as separate soaks"
        )
        assert not (multitenant and (strong or overload or composite or gc)), (
            "--multitenant drives its own action table over the keyspace "
            "tier; run the other modes as separate soaks"
        )
        assert not (audit and (strong or overload or composite or gc
                               or multitenant)), (
            "--audit rides the default action table with its own frontier "
            "cadence and durable-crash rule; run the other modes as "
            "separate soaks"
        )
        self.seed = seed
        self.steps = steps
        self.postmortem_dir = postmortem_dir
        self.assemble_check = assemble_check
        # gc mode: stability-frontier GC rides the run on a fixed cadence;
        # run_soak additionally replays a GC-off shadow arm and requires
        # bit-equal convergence plus a strictly smaller retained log
        self.gc = gc
        # strong mode: linearizable reads + CAS join the action table,
        # with clock pinning making the never-stale audit exact
        self.strong = strong
        # crash-coordinator mode: leaseholder kills mid-CAS + zombie
        # handoffs join the strong table; the fence-decision oracle
        # (<=1 decider per (slot, fence)) gates the heal
        self.crash_coordinator = crash_coordinator
        # audit mode: the divergence audit plane under fire — frontier
        # GC on the --gc cadence (digests only compare at non-empty
        # frontiers), a watchdog tick every step, and (plant arm) silent
        # winner-ts flips scheduled on the op="state" pseudo-edge.
        # Crashes are DURABLE here: an amnesia reboot could regress a vv
        # below an already-minted frontier, and the resulting
        # wire-summary adoption would heal (or spread) the planted
        # corruption mid-run — breaking the 1:1 provenance accounting
        # both ways.
        self.audit = audit
        self.audit_plant = audit and audit_plant
        self.audit_planted: List[Dict[str, Any]] = []
        self._audit_planted_slots: set = set()
        # driver-side truth for the --gc summary audit: running pointwise
        # max of every member's vv, sampled at the end of every step (a
        # summary may lag but can never exceed this)
        self.true_vv: Dict[str, Dict[int, int]] = {}
        # --strong audit state: last quorum-committed value per register,
        # plus the still-outstanding indeterminate writes that may land
        self.strong_committed: Dict[str, Optional[str]] = {}
        self.strong_pending: Dict[str, set] = {}
        self.strong_view: Dict[str, Optional[str]] = {}
        self.strong_gen = 0
        # --strong prefix-oracle journal: per-rid mint-ordered op list
        # (kind, key, value) with a global order stamp — CAS ops share
        # the rid seq space with plain writes, so the vv prefix is a walk
        # of this journal rather than a k{rid}-{seq} count
        self.minted: Dict[int, List[Tuple[int, str, str, str]]] = {}
        self.mint_order = 0
        # overload mode: writes also arrive as admission BURSTS through
        # each host's ingest front door, against a deliberately tiny
        # high-water mark — sheds must be client-visible (ShedError, the
        # in-process analogue of HTTP 429), black-boxed, and counted 1:1;
        # admitted ops still satisfy the prefix oracle after heal
        self.overload = overload
        self.sheds_client = 0
        self.shed_ops_client = 0
        self.pages_corrupt_client = 0
        # multitenant mode: tenant-scoped writes through each host's
        # keyspace front door (crdt_tpu_torch.keyspace) — per-tenant admission
        # ledger, unique-key mint counter over the simulated universe,
        # and the noisy tenant's client-side shed/quarantine counts the
        # oracle reconciles 1:1 against tenant-labeled events
        self.multitenant = multitenant
        # reshard mode: the fleet boots at 2 shards and migrates to the
        # MT_SHARDS map online, mid-fault-schedule.  The window bounds
        # sit OUTSIDE the action rng (like the GC cadence) so both
        # replay arms drive the identical choreography.
        self.reshard = reshard
        self.rs_shards0 = 2 if reshard else self.MT_SHARDS
        self.rs_target = self.MT_SHARDS
        if reshard:
            self.rs_start = max(2, steps // 3)
            self.rs_cutover = max(self.rs_start + 6, (2 * steps) // 3)
            # the durable crash lands mid-window; the reboot (which
            # must RESUME from the reshard ledger) stays pre-cutover
            self.rs_crash_step = (self.rs_start + self.rs_cutover) // 2
            self.rs_reboot_step = min(self.rs_crash_step + 3,
                                      self.rs_cutover - 1)
        # driver-side predictions for the 1:1 reshard reconciliations
        self.rs_fences_pred = 0
        self.rs_quar_client = 0
        self.mt_expected: Dict[str, Dict[str, str]] = {
            t: {} for t in (*self.MT_TENANTS, self.MT_NOISY)}
        self.mt_next = 0
        self.mt_sheds_client = 0
        self.mt_shed_ops_client = 0
        self.mt_corrupt_client = 0
        self.mt_pagers: Dict[str, Any] = {}
        if multitenant:
            from crdt_tpu_torch.ingest import PageBuilder
            # one builder per tenant (origins clear of the slot indices
            # overload mode uses); the builders are DRIVER-side, so
            # their page_seq counters survive host crashes — a reboot's
            # restored (or reset) watermark only ever sees higher seqs,
            # which the gap-tolerant dup check admits
            self.mt_pagers = {
                t: PageBuilder(origin=1000 + j, page_size=1 << 20)
                for j, t in enumerate((*self.MT_TENANTS, self.MT_NOISY))
            }
        # composite mode: the served mapof(pncounter) (api/compositenode)
        # rides every phase — writes mix in composite upd/rem, every edge
        # pull also pulls the composite surface through the SAME faulty
        # transport, convergence additionally requires fingerprint
        # equality, and the quarantine ledger must account for corrupted
        # composite payloads 1:1
        self.composite = composite
        self._tmp = tempfile.TemporaryDirectory(prefix="nemesis_soak_")
        self.root = self._tmp.name
        # strong mode disables schedule clock skew: linearizable CAS over
        # an LWW register needs ts order == mint order, which the per-step
        # clock pinning provides and a skew event would re-break.  Skew
        # tolerance stays pinned by the default soak.  Audit mode drops
        # skew too: a skew event mutates epoch_ms in place, silently
        # re-timing every already-hashed absolute-ts row — a legitimate
        # store-vs-digest drift the scrub would convict with no planted
        # fault behind it, voiding the 1:1 accounting (cross-epoch digest
        # comparability is pinned by tests/test_audit.py instead).
        self.schedule = NemesisSchedule.generate(
            seed, nodes, steps, clock_skew=not (strong or audit))
        if self.audit_plant:
            # flip windows on the op="state" pseudo-edge, appended BEFORE
            # the plane exists so --replay-check covers these rules too;
            # the window opens late enough for the first frontier fold to
            # have populated _summary (plants target folded rows)
            from crdt_tpu_torch.faults.schedule import divergence_rules

            self.schedule = dataclasses.replace(
                self.schedule,
                rules=self.schedule.rules + tuple(
                    divergence_rules(max(2, steps // 4), steps, p=0.1)),
            )
        if reshard:
            # aim corrupt + drop windows at the migration stream itself
            # (op "ks_migrate"); appended BEFORE the plane exists so the
            # replay-check covers these rules too
            from crdt_tpu_torch.faults.schedule import reshard_window_rules

            self.schedule = dataclasses.replace(
                self.schedule,
                rules=self.schedule.rules + tuple(
                    reshard_window_rules(self.rs_start, self.rs_cutover)),
            )
        self.plane = FaultPlane(self.schedule, log_path=fault_log)
        # fleet-shared birth ledger: every slot's flight recorder converts
        # newly-visible seqs to step lags against it (obs/provenance)
        self.ledger = BirthLedger()
        # keyspace tier: one fleet-shared ledger PER SHARD — shard i
        # holds the same (rid, seq) space on every node (and reuses the
        # host plane's rid + seq-from-0 space), so per-shard ledgers keep
        # the ranges disjoint without any dedup table
        self.ks_ledgers = [BirthLedger() for _ in range(self.rs_shards0)] \
            if multitenant else None
        # last fleet SLO rollup (obs/fleet), kept for the postmortem
        self._fleet_report = None
        ingest_kw = {}
        if overload:
            # the shed point must be REACHABLE: flush-on-size drains at
            # ingest_flush_ops, so the high-water mark sits well below it
            # and a burst piles depth into the shed region before any
            # size-triggered drain can relieve it
            ingest_kw = dict(ingest_flush_ops=64, ingest_flush_ms=5.0,
                             ingest_high_water=24, ingest_retry_after_s=0.01)
        if strong:
            # fake-clock budget per strong op: the catch-up loop polls at
            # most timeout/poll times, so a stuck op costs a bounded,
            # replayable number of proxy rounds before its loud 503
            ingest_kw.update(strong_timeout_s=2.0, session_poll_s=0.25)
        if multitenant:
            # per-shard plane capacity scaled to the horizon (a step mints
            # at most ~8 ops across 4 shards, so 4*steps per shard is a
            # wide margin even under routing imbalance); the noisy tenant
            # gets a quota slice small enough that its bursts always trip
            # reshard mode sizes capacity for the cutover rebirth: every
            # node re-mints the full winner set into fresh planes and
            # post-cutover anti-entropy unions the per-node mints, so a
            # shard may retain ~nodes x its keys until the post-heal GC
            ingest_kw.update(
                keyspace_shards=self.rs_shards0,
                keyspace_capacity=max(256, 4 * steps) * (
                    nodes + 1 if reshard else 1),
                keyspace_tenant_quota={self.MT_NOISY: self.MT_NOISY_QUOTA},
                # the mesh plane's fused shard convergence: "on" forces the
                # fused step even on one device, so the corrupt-shard
                # isolation INSIDE the fused step runs deterministically
                keyspace_mesh=ks_mesh,
            )
        self.config = ClusterConfig(
            n_replicas=nodes, seed=seed,
            gossip_period_ms=600_000,  # external drive only (determinism)
            peer_timeout_s=2.0,
            peer_backoff_base_s=1.0, peer_backoff_cap_s=5.0,
            **ingest_kw,
        )
        self.rng = random.Random(f"nemesis-soak:{seed}")
        ports = _free_ports(nodes)
        # lease routing ranks member URLS; with OS-assigned ports the
        # rendezvous would re-draw coordinators every run and the wire-
        # call schedule (hence the fault log) would never replay — rank
        # over stable member names instead
        self.member_ident = {
            f"http://127.0.0.1:{p}": f"member-{i}"
            for i, p in enumerate(ports)
        }
        self.slots = [
            _Slot(self, i, ports[i],
                  [j for j in range(nodes) if j != i],
                  [ports[j] for j in range(nodes) if j != i])
            for i in range(nodes)
        ]
        for s in self.slots:
            s.boot()
        # write ledger: wire rid -> how many commands that writer minted
        # (key/value are derived from (rid, seq), so the ledger IS the
        # prefix oracle)
        self.writes: Dict[int, int] = {}
        # strict-join gate baseline: the truncation tally is process-global
        # (other tests in the same process deliberately trigger refusals),
        # so the zero-truncations assertion is on the DELTA over this run
        from crdt_tpu_torch.ops import union_engine

        self._truncations_at_start = union_engine.truncation_count()
        self.report = NemesisReport(seed=seed, steps=steps, nodes=nodes)

    # ---- step-phase actions (all rng-scheduled, all deterministic) ----

    def _alive(self) -> List[_Slot]:
        return [s for s in self.slots if s.alive]

    def _write(self) -> None:
        slot = self.rng.choice(self._alive())
        if self.composite and self.rng.random() < 0.4:
            # composite-mode write: upd/rem on the contended key pool.
            # Deliberately NOT in self.writes — the composite has no
            # (rid, seq) ledger; its oracle is fingerprint equality
            key = self.rng.choice(self.COMPOSITE_KEYS)
            cn = slot.host.composite_node
            if self.rng.random() < 0.25:
                cn.rem(key)
            else:
                cn.upd(key, self.rng.randint(-9, 9))
            self.report.composite_ops += 1
            return
        rid = slot.host.node.rid
        seq = self.writes.get(rid, 0)
        if slot.host.node.add_command({f"k{rid}-{seq}": f"v{rid}-{seq}"}):
            self.writes[rid] = seq + 1
            self.report.writes += 1
            self._journal(rid, "kv", f"k{rid}-{seq}", f"v{rid}-{seq}")

    def _journal(self, rid: int, kind: str, key: str, value: str) -> None:
        """Strong-mode mint journal: CAS ops share each rid's seq space
        with plain writes, so the prefix oracle walks this per-rid,
        mint-ordered journal instead of counting k{rid}-{seq} keys.  The
        global order stamp resolves shared strong registers: with pinned
        clocks, LWW order == mint order."""
        if not self.strong:
            return
        self.mint_order += 1
        self.minted.setdefault(rid, []).append(
            (self.mint_order, kind, key, value))

    def _overload_burst(self) -> None:
        """Admission burst through a live host's ingest front door, against
        the overload config's tiny high-water mark.  The driver is
        single-threaded, so queue depth moves only through these submits
        and the final explicit flush — every group's outcome is
        deterministic: it either sheds (client-counted, nothing minted) or
        admits, and an admitted group's idents must equal the seqs
        predicted from the write ledger, because drains preserve
        submission order and sheds mint nothing."""
        from crdt_tpu_torch.faults.transport import corrupt_page_bytes
        from crdt_tpu_torch.ingest import PageFormatError, ShedError

        slot = self.rng.choice(self._alive())
        fd = slot.host.ingest
        rid = slot.host.node.rid
        seq = self.writes.get(rid, 0)
        if self.rng.random() < 0.25:
            # the page door rides the same policy: a shed page is lost
            # whole (this client opts not to retry — its page_seq is
            # simply skipped, which the watermark tolerates), an admitted
            # one advances the ledger like any write
            n = self.rng.randint(4, 12)
            for i in range(n):
                slot.pager.add(f"k{rid}-{seq + i}", f"v{rid}-{seq + i}")
            raw = slot.pager.flush()
            if self.rng.random() < 0.3:
                # page-corruption rule: one flipped payload byte must
                # quarantine the page WHOLE — zero of its ops admitted,
                # the ledger untouched (these keys are re-minted by later
                # writes at the same seqs, so a partial admission would
                # trip the prefix oracle)
                try:
                    fd.admit_page(corrupt_page_bytes(raw, self.rng),
                                  timeout=5.0)
                except PageFormatError:
                    self.pages_corrupt_client += 1
                    return
                raise AssertionError(
                    "corrupt op page was admitted instead of quarantined")
            try:
                res = fd.admit_page(raw, timeout=5.0)
            except ShedError:
                self.sheds_client += 1
                self.shed_ops_client += n
                return
            assert not res["dup"] and res["admitted"] == n, res
            self.writes[rid] = seq + n
            self.report.writes += n
            return
        admitted = []
        for _ in range(self.rng.randint(6, 12)):
            n = self.rng.randint(4, 12)
            items = [(None, {f"k{rid}-{seq + i}": f"v{rid}-{seq + i}"})
                     for i in range(n)]
            try:
                ticket = fd.kv.submit_many(items)
            except ShedError:
                self.sheds_client += 1
                self.shed_ops_client += n
                continue
            admitted.append((ticket, seq, n))
            seq += n
        fd.kv.flush()
        for ticket, first, n in admitted:
            idents = ticket.wait(5.0)
            assert idents == [(rid, first + i) for i in range(n)], (
                f"burst group minted {idents[:3]}..., predicted "
                f"({rid}, {first})..+{n}: admission order broken"
            )
        if admitted:
            _, first, _ = admitted[0]
            _, last, last_n = admitted[-1]
            self.writes[rid] = last + last_n
            self.report.writes += last + last_n - first

    # ---- --multitenant actions (keyspace tier, transport faults only) ----

    def _mt_key(self) -> str:
        """One unique key from the simulated million-key universe: the
        coprime stride walks all 1e6 indices before repeating, so draws
        never collide (no cross-node LWW ties for the oracle to model)
        while routing sees the whole hash range."""
        idx = (self.mt_next * self.MT_STRIDE) % self.MT_UNIVERSE
        self.mt_next += 1
        return f"u{idx:06d}"

    def _mt_write(self) -> None:
        """One well-behaved tenant writes a small dict through a live
        host's keyspace door (/data form): pairs fan out to their owning
        shards, admission is all-or-nothing, and every ident must mint —
        good tenants ride the lane mark and may never shed."""
        slot = self.rng.choice(self._alive())
        tenant = self.rng.choice(self.MT_TENANTS)
        cmd = {}
        for _ in range(self.rng.randint(1, 4)):
            k = self._mt_key()
            cmd[k] = "v" + k
        idents = slot.host.ks_door.admit_cmd(tenant, cmd, timeout=5.0)
        assert all(i is not None for i in idents), (
            f"tenant {tenant!r} write lost idents: {idents}")
        self.mt_expected[tenant].update(cmd)
        self.report.writes += len(cmd)

    def _mt_page(self) -> None:
        """One well-behaved tenant ships a columnar op page: rows fan out
        to multiple shards but the page admits (or would shed) WHOLE."""
        slot = self.rng.choice(self._alive())
        tenant = self.rng.choice(self.MT_TENANTS)
        pager = self.mt_pagers[tenant]
        rows = {}
        for _ in range(self.rng.randint(3, 8)):
            k = self._mt_key()
            rows[k] = "v" + k
            pager.add(k, rows[k])
        res = slot.host.ks_door.admit_page(pager.flush(), tenant,
                                           timeout=5.0)
        assert not res["dup"] and res["admitted"] == len(rows), res
        self.mt_expected[tenant].update(rows)
        self.report.writes += len(rows)

    def _mt_noisy(self) -> None:
        """The noisy tenant: corrupt pages (quarantined whole, tenant-
        labeled), bursts past its quota slice (shed whole with the
        tenant-lane label — its neighbors keep writing), and the odd
        inside-quota write (admitted noisy ops must still converge).
        Every rejection is client-counted for the 1:1 reconciliation."""
        from crdt_tpu_torch.faults.transport import corrupt_page_bytes
        from crdt_tpu_torch.ingest import PageFormatError, ShedError
        from crdt_tpu_torch.keyspace import TENANT_LANE

        slot = self.rng.choice(self._alive())
        tenant = self.MT_NOISY
        pager = self.mt_pagers[tenant]
        roll = self.rng.random()
        if roll < 0.35:
            for _ in range(self.rng.randint(2, 6)):
                k = self._mt_key()
                pager.add(k, "v" + k)
            try:
                slot.host.ks_door.admit_page(
                    corrupt_page_bytes(pager.flush(), self.rng), tenant,
                    timeout=5.0)
            except PageFormatError:
                self.mt_corrupt_client += 1
                return
            raise AssertionError(
                "corrupt tenant page was admitted instead of quarantined")
        if roll < 0.75:
            # the driver waits every admitted ticket, so the tenant's
            # pending depth is 0 here — a burst one past the quota slice
            # deterministically sheds WHOLE at the tenant lane
            n = self.MT_NOISY_QUOTA + self.rng.randint(1, 4)
            for _ in range(n):
                k = self._mt_key()
                pager.add(k, "v" + k)
            try:
                slot.host.ks_door.admit_page(pager.flush(), tenant,
                                             timeout=5.0)
            except ShedError as e:
                assert e.tenant == tenant and e.lane == TENANT_LANE, e
                self.mt_sheds_client += 1
                self.mt_shed_ops_client += n
                return
            raise AssertionError(
                "noisy burst above the quota slice was admitted")
        cmd = {}
        for _ in range(self.rng.randint(1, 4)):
            k = self._mt_key()
            cmd[k] = "v" + k
        idents = slot.host.ks_door.admit_cmd(tenant, cmd, timeout=5.0)
        assert all(i is not None for i in idents), (
            f"inside-quota noisy write lost idents: {idents}")
        self.mt_expected[tenant].update(cmd)
        self.report.writes += len(cmd)

    # ---- --reshard: the choreographed online S -> S' migration ----

    def _rs_cutover_one(self, slot: "_Slot") -> None:
        """Finish one node's reshard through the admin surface: open
        the window first if its machine is idle (a node rebooted from a
        pre-window checkpoint), then cut over."""
        host = slot.host
        if host.keyspace.reshard.phase == "idle":
            host.admin_ks_reshard(
                {"action": "start", "shards": self.rs_target})
        out = host.admin_ks_reshard({"action": "cutover"})
        assert out["epoch"] == 1 and out["n_shards"] == self.rs_target, (
            f"slot {slot.slot} cutover landed wrong: {out}")

    def _drive_reshard(self, step: int) -> None:
        """The reshard choreography, driven OUTSIDE the action rng (the
        GC-cadence trick: both replay arms see the identical stream)
        and BEFORE the step's action, so a slot rebooted with a stale
        epoch is always finalized before any rng pull can reach it:

        * ``rs_start .. rs_cutover`` — every live node holds a MIGRATE
          window toward ``rs_target`` and streams its moved-key slices
          each step through /admin/ks_reshard (the admin surface);
          the choreographed DURABLE crash lands mid-window and its
          reboot must resume the window from the persisted ledger;
        * ``rs_cutover`` — slot 0 cuts over FIRST; the driver then
          forces one stale pull from every other live node, predicting
          the 409 exactly (``plane.decide`` is the per-message truth,
          so an active drop rule is predicted too), and cuts the rest
          over in the same call — the rng action stream never sees a
          mixed-epoch fleet;
        * afterwards — stragglers rebooted with a pre-cutover ledger
          are finalized here before the step's action runs.
        """
        if step < self.rs_start:
            return
        if step < self.rs_cutover:
            if step == self.rs_crash_step:
                slot = self.slots[1]
                if slot.alive and len(self._alive()) >= 2:
                    slot.crash(durable=True)
                    self.report.crashes += 1
            if step == self.rs_reboot_step and not self.slots[1].alive:
                self.slots[1].boot()
                self.report.reboots += 1
            # two passes on purpose: every live machine enters MIGRATE
            # before anyone streams, so no slice ever lands on an
            # epoch-matched but not-yet-started receiver (whose 409
            # would be an unpredicted fence)
            live = self._alive()
            for s in live:
                ks = s.host.keyspace
                if ks.epoch == 0 and ks.reshard.phase == "idle":
                    s.host.admin_ks_reshard(
                        {"action": "start", "shards": self.rs_target})
            for s in live:
                out = s.host.admin_ks_reshard({"action": "stream"})
                self.report.rs_streams += int(out.get("sent", 0))
                self.rs_quar_client += int(out.get("quarantined", 0))
            return
        if step == self.rs_cutover:
            lead = self.slots[0]
            if not lead.alive:
                lead.boot()
                self.report.reboots += 1
            self._rs_cutover_one(lead)
            for s in self._alive():
                if s is lead or s.host.keyspace.epoch != 0:
                    continue
                dropped = "drop" in self.plane.decide(
                    str(s.slot), "0", "ks_gossip")
                merged = s.host.agent.ks_pull(s.transports[0])
                assert merged == 0, (
                    f"slot {s.slot}: a stale-epoch pull merged {merged} "
                    "ops through the fence")
                if not dropped:
                    self.rs_fences_pred += 1
                self._rs_cutover_one(s)
            return
        for s in self._alive():
            if s.host.keyspace.epoch == 0:
                self._rs_cutover_one(s)

    def _pull(self) -> None:
        src = self.rng.choice(self._alive())
        dst = self.rng.choice(src.peer_slots)
        t = src.transports[dst]
        if t.backed_off():
            self.report.backoff_skips += 1
            return
        self.report.pulls += 1
        if src.host.agent.pull_from(t):
            self.report.merges += 1
        if self.composite:
            # the composite rides the same edge through the same faulty
            # transport: its payload crosses the nemesis too
            src.host.agent.composite_pull(t)
        if self.multitenant:
            # every shard's delta crosses the same faulty edge; corrupt
            # /ks/gossip bodies hit the parse-skip path (first-byte flip
            # breaks the JSON envelope), truncated ones likewise — a
            # shard round is skipped, never half-merged
            src.host.agent.ks_pull(t)

    def _checkpoint(self) -> None:
        slot = self.rng.choice(self._alive())
        h = slot.host
        _, torn = slot.disk.save(
            slot.ckpt_dir, h.node, set_node=h.set_node,
            seq_node=h.seq_node, map_node=h.map_node,
            composite_node=h.composite_node,
            keyspace=h.keyspace, leases=h.leases,
        )
        self.report.checkpoints += 1
        if torn:
            self.report.torn_writes += 1

    def _crash(self) -> None:
        alive = self._alive()
        if len(alive) < 2:
            return  # always keep a survivor carrying the fleet's state
        self.rng.choice(alive).crash()
        self.report.crashes += 1

    def _reboot(self) -> None:
        dead = [s for s in self.slots if not s.alive]
        if dead:
            self.rng.choice(dead).boot()
            self.report.reboots += 1

    def _mt_crash(self) -> None:
        """Multitenant crash: DURABLE (atomic flush of every plane —
        keyspace shards and the reshard ledger included — then the
        SIGKILL analogue).  Admitted tenant writes survive by contract,
        so the per-tenant ledger oracle keeps holding across reboots;
        mid-MIGRATE, the flushed reshard ledger is what the reboot
        resumes the window from."""
        alive = self._alive()
        if len(alive) < 2:
            return  # always keep a survivor carrying the fleet's state
        self.rng.choice(alive).crash(durable=True)
        self.report.crashes += 1

    def _barrier(self) -> None:
        coord = self.slots[0]
        if coord.alive and coord.host.agent.compact_once():
            self.report.barriers += 1

    def _pin_clocks(self, step: int) -> None:
        """Strong mode: advance every live node's _BandClock to this
        step's private band.  epoch_ms never moves (see _BandClock: a
        moving epoch desyncs the cached wire encodings and diverges LWW);
        only the band of freshly minted timestamps does."""
        for s in self._alive():
            s.host.node.clock.band = int(step)

    def _journal_at(self, rid: int, seq: int, kind: str, key: str,
                    value: str) -> None:
        """Journal a strong mint under the identity the PLANE reported.
        With leases routing CAS to a coordinator, the minting rid is the
        DECIDER's, not the caller's — the returned session token (or the
        503's attached token) is the only honest source.  The driver is
        single-threaded, so every rid's mints arrive here in seq order;
        the contiguity assert catches any decider the driver missed."""
        if not self.strong:
            return
        entries = self.minted.setdefault(rid, [])
        assert seq == len(entries), (
            f"mint journal gap for writer {rid}: plane reported seq "
            f"{seq} but the journal holds {len(entries)} entries — an "
            "unjournaled decision slipped past the driver"
        )
        self.mint_order += 1
        entries.append((self.mint_order, kind, key, value))

    def _strong_op(self, slot: Optional["_Slot"] = None,
                   key: Optional[str] = None,
                   force_cas: bool = False) -> None:
        """One linearizable read or CAS through a live host's consistency
        plane (its quorum legs cross the FaultyTransports; CAS from a
        non-coordinator FORWARDS to the routed leaseholder).  Every
        outcome feeds the never-stale audit; every ConsistencyUnavailable
        is counted for the 1:1 event reconciliation after heal."""
        from crdt_tpu_torch.consistency import CasConflict, ConsistencyUnavailable

        slot = slot if slot is not None else self.rng.choice(self._alive())
        cons = slot.host.consistency
        key = key if key is not None else self.rng.choice(self.STRONG_KEYS)
        if not force_cas and self.rng.random() < 0.5:
            try:
                val = cons.read(key, level="linearizable")
            except ConsistencyUnavailable:
                self.report.strong_unavailable += 1
                return
            self.report.strong_ok += 1
            self._audit_strong(key, val, op="read")
            self.strong_view[key] = val
            return
        self.strong_gen += 1
        new = f"g{self.strong_gen}"
        try:
            token = cons.cas(key, self.strong_view.get(key), new)
        except CasConflict as e:
            # the conflict's ACTUAL rode the same quorum read — audit it
            # like any linearizable result, then adopt it as our view
            self.report.strong_conflicts += 1
            self._audit_strong(key, e.actual, op="cas_conflict")
            self.strong_view[key] = e.actual
            return
        except ConsistencyUnavailable as e:
            self.report.strong_unavailable += 1
            if e.indeterminate:
                # minted but not quorum-acked: the op may still land via
                # anti-entropy.  The 503 carries the minted identity when
                # one exists (it occupies vv space — journal it); a bare
                # indeterminate means the forward died BEFORE any mint
                # (transport drop), so there is nothing to journal and
                # the value can never land.  Either way allow the value
                # until the next committed CAS supersedes it (pinned ts
                # ⇒ later commits always win LWW).
                self.report.strong_indeterminate += 1
                self.strong_pending.setdefault(key, set()).add(new)
                if e.token:
                    (rid, seq), = e.token.items()
                    self._journal_at(rid, seq, "strong", key, new)
            return
        self.report.strong_ok += 1
        (rid, seq), = token.items()
        self._journal_at(rid, seq, "strong", key, new)
        self.strong_committed[key] = new
        self.strong_pending[key] = set()
        self.strong_view[key] = new

    def _audit_strong(self, key: str, val: Optional[str], op: str) -> None:
        """The never-stale oracle: a linearizable result may only be the
        last quorum-committed value or a still-outstanding indeterminate
        write.  Anything older means a strong read silently served stale
        state — exactly what the 503 posture forbids."""
        allowed = ({self.strong_committed.get(key)}
                   | self.strong_pending.get(key, set()))
        assert val in allowed, (
            f"stale {op} on {key!r}: got {val!r}, but only "
            f"{sorted(x if x is not None else '<absent>' for x in allowed)} "
            f"are linearizable (committed or indeterminate-outstanding)"
        )

    # ---- --crash-coordinator: leaseholder kills + zombie handoffs ----

    def _lease_slot_holder(self, key: str):
        """(lease slot, acting holder) for a strong register — holder is
        the live slot whose lease table says 'held and unexpired' for the
        key's routing slot, or None when nobody currently holds it."""
        from crdt_tpu_torch.consistency.leases import slot_of_key

        lslot = slot_of_key(key, self.config.lease_slots)
        holder = next(
            (s for s in self._alive()
             if s.host.leases.held_fence(lslot) is not None), None)
        return lslot, holder

    def _crash_leaseholder(self) -> None:
        """Kill the acting leaseholder mid-CAS: the decision is minted on
        the holder (exactly where _cas_decide mints, post-expect-check)
        but the holder dies before ANY fenced push leg runs.  Strong
        crashes are fail-stop, so the mint survives on its disk and may
        land via anti-entropy after reboot — the op is journaled under
        the holder's rid and allowed as indeterminate-outstanding, never
        counted committed.  No client saw an ack, so no 503 is counted
        either (the driver IS the client that died with the call)."""
        alive = self._alive()
        if len(alive) < 3:
            return  # the kill leaves >= 2 carrying the fleet's state
        key = self.rng.choice(self.STRONG_KEYS)
        lslot, holder = self._lease_slot_holder(key)
        if holder is None:
            # nobody holds the slot yet: spend the step minting a lease
            # (a CAS routes to the rendezvous coordinator, which acquires)
            self._strong_op(key=key, force_cas=True)
            return
        h = holder.host
        rid = h.node.rid
        self.strong_gen += 1
        new = f"g{self.strong_gen}"
        if not h.node.add_command({key: new}):
            return
        seq = h.node.version_vector()[rid]
        self._journal_at(rid, seq, "strong", key, new)
        self.strong_pending.setdefault(key, set()).add(new)
        holder.crash()
        self.report.crashes += 1
        self.report.coordinator_crashes += 1

    def _zombie_handoff(self) -> None:
        """The zombie-coordinator scenario: every OTHER node's fake clock
        jumps past the holder's lease (a paused/partitioned process whose
        own clock stayed behind), a successor acquires fence+1 by quorum,
        and the zombie's next CAS — stamped with its stale fence — must
        be refused fleet-wide (cas_fenced_reject) and surface as an
        indeterminate 503, never a second commit under the old epoch."""
        alive = self._alive()
        if len(alive) < 3:
            return
        key = self.rng.choice(self.STRONG_KEYS)
        from crdt_tpu_torch.consistency.leases import slot_of_key

        lslot = slot_of_key(key, self.config.lease_slots)
        # the zombie must be a holder that would DECIDE locally (its own
        # routing view names itself) — a stale holder whose view forwards
        # would just relay to the real coordinator, testing nothing
        zombies = [
            s for s in alive
            if s.host.leases.held_fence(lslot) is not None
            and s.host.leases.coordinator_of(lslot)
            == s.host.leases.own_url
        ]
        if not zombies:
            self._strong_op(key=key, force_cas=True)
            return
        zombie = zombies[0]
        # freshen the grant first: a zombie is a coordinator whose lease
        # was FRESH when the world moved on.  Within the half-life window
        # its next ensure() answers from the local table without a wire
        # round — exactly the stale-stamp path the fence must catch.  (A
        # stale-enough grant would instead renew over the wire, learn the
        # raised fence, and legitimately re-acquire — self-healing, but
        # not the scenario.)
        zombie.host.leases.ensure(lslot)
        old_fence = zombie.host.leases.held_fence(lslot)
        if old_fence is None:
            return
        for s in alive:
            if s is not zombie:
                s.plane_time.t += self.config.lease_duration_s + 1.0
        succ = self.rng.choice([s for s in alive if s is not zombie])
        # direct acquisition on the successor emulates the breaker-aged
        # routing handoff (the rendezvous view stops naming a dead edge);
        # faults may refuse the grant quorum — then no handoff happened
        # and the zombie's push legitimately still commits under its own
        # unexpired-by-quorum fence
        fence = succ.host.leases.ensure(lslot)
        handoff = fence is not None and fence > (old_fence or 0)
        before = self.report.strong_indeterminate
        before_rej = self._fenced_rejects_total()
        self._strong_op(slot=zombie, key=key, force_cas=True)
        # a zombie ATTEMPT is only the full story: handoff granted, the
        # stale-stamped push actually refused somewhere (metric inc'd on
        # the refusing replicas), and the zombie got its loud 503 — a
        # transport drop that starved the push legs is a different fault
        if (handoff and self.report.strong_indeterminate > before
                and self._fenced_rejects_total() > before_rej):
            self.report.zombie_attempts += 1

    def _fenced_rejects_total(self) -> int:
        """Fleet-wide ``cas_fenced_rejects`` counter fold (each refusing
        replica incs its own registry)."""
        return sum(
            int(v) for s in self._alive()
            for k, v in s.host.node.metrics.registry.snapshot().items()
            if k.startswith("cas_fenced_rejects"))

    def step(self, step: int) -> None:
        self.plane.step = step
        if self.strong:
            self._pin_clocks(step)
        for skew in self.plane.skews_at(step):
            slot = self.slots[int(skew.node)]
            if slot.alive:
                # shrinking the epoch moves now_ms forward, growing it
                # moves it back (clamped at 0 by HostClock)
                slot.host.node.clock.epoch_ms -= skew.skew_ms
                self.plane.record("clock_skew", node=skew.node,
                                  skew_ms=skew.skew_ms)
        if self.reshard:
            self._drive_reshard(step)
        if self.overload:
            action = self.rng.choices(
                ("write", "pull", "checkpoint", "crash", "reboot",
                 "barrier", "overload_burst"),
                weights=(27, 33, 8, 4, 6, 2, 20),
            )[0]
        elif self.strong and self.crash_coordinator:
            # plain crashes stay in the mix (they may hit non-holders);
            # the two targeted scenarios take their slice from them and
            # from writes, keeping pull/checkpoint pressure intact
            action = self.rng.choices(
                ("write", "pull", "checkpoint", "crash", "reboot",
                 "barrier", "strong_op", "crash_leaseholder",
                 "zombie_handoff"),
                weights=(31, 33, 8, 2, 8, 2, 8, 5, 3),
            )[0]
        elif self.strong:
            action = self.rng.choices(
                ("write", "pull", "checkpoint", "crash", "reboot",
                 "barrier", "strong_op"),
                weights=(35, 33, 8, 4, 6, 2, 12),
            )[0]
        elif self.multitenant:
            # keyspace shards checkpoint + restore like every other
            # plane (ks-shard-*.json + the reshard ledger), so crashes
            # and reboots ride this arm too.  Crashes are DURABLE (an
            # atomic flush precedes the kill): admitted tenant writes
            # survive by contract, which is exactly what keeps the
            # per-tenant admission ledger a valid oracle across reboots
            # — and what _check_mt_restores audits (verified,
            # non-fallback restores only)
            action = self.rng.choices(
                ("mt_write", "mt_page", "pull", "mt_noisy",
                 "checkpoint", "mt_crash", "reboot"),
                weights=(27, 13, 32, 17, 4, 3, 4),
            )[0]
        else:
            action = self.rng.choices(
                ("write", "pull", "checkpoint", "crash", "reboot",
                 "barrier"),
                weights=(45, 35, 8, 4, 6, 2),
            )[0]
        getattr(self, f"_{action}")()
        if self.gc:
            # the GC drive and truth sampling sit OUTSIDE the action rng:
            # the GC-off shadow arm consumes the identical random stream
            if step % self.GC_EVERY == 0:
                self._drive_gc(step)
            self._sample_true_vvs()
        if self.audit:
            # same rule: the audit drive sits OUTSIDE the action rng, so
            # the plant-free arm replays the identical action stream and
            # issues the identical decide() calls — the wire-call census
            # comparison in run_soak is exact
            if step % self.GC_EVERY == 0:
                # the action table's one-random-edge pulls are too sparse
                # for the coordinator to hold a FRESH summary from every
                # member, so mid-run mints would never fire and no row
                # would ever fold for a plant to flip: refresh the
                # coordinator's tracker through its faulty transports
                # first (partitions still starve it — mints only land in
                # clean windows, which is the point of a soak)
                coord = self.slots[0]
                if coord.alive:
                    for t in coord.transports.values():
                        if not t.backed_off():
                            coord.host.agent.pull_from(t)
                self._drive_gc(step)
            self._sample_true_vvs()
            self._drive_audit(step)

    # ---- --gc: coordinated GC drive + the safety oracle ----

    def _url_of(self, slot: "_Slot") -> str:
        return f"http://127.0.0.1:{slot.port}"

    def _sample_true_vvs(self) -> None:
        """Fold every live node's vv into the driver's running-max truth
        (keyed by member URL — the tracker's member identity).  Sampled at
        the end of every step, so any summary the coordinator captured can
        claim at most what some incarnation actually held."""
        for s in self._alive():
            acc = self.true_vv.setdefault(self._url_of(s), {})
            for r, q in s.host.node.version_vector().items():
                if q > acc.get(r, -1):
                    acc[r] = q

    def _drive_gc(self, step: int) -> None:
        """One coordinated GC attempt through the coordinator's agent,
        followed by the mint audit: the minted frontier must sit under the
        coordinator's own vv AND under every member's vouched summary, and
        every summary must sit under the running-max true vv the driver
        recorded — a tracker that ever invents stability fails here, not
        in a converged-state diff three phases later."""
        coord = self.slots[0]
        if not coord.alive:
            self.report.gc_skips += 1
            return
        self._sample_true_vvs()
        tracker = coord.host.agent.stability
        own_vv = coord.host.node.version_vector()
        n_ledger = len(tracker.ledger)
        frontier = coord.host.agent.stability_gc_once(step=step)
        if not frontier:
            self.report.gc_skips += 1
            return
        self.report.gc_mints += 1
        assert len(tracker.ledger) == n_ledger + 1, (
            "mint without a matching audit-ledger record"
        )
        rec = tracker.ledger[-1]
        assert rec["frontier"] == frontier and rec["step"] == step, rec
        for r, q in frontier.items():
            assert q <= own_vv.get(r, -1), (
                f"minted frontier claims ({r},{q}) beyond the "
                f"coordinator's own vv {own_vv}"
            )
        for m in tracker.members:
            summ = rec["summaries"].get(m)
            assert summ is not None, (
                f"frontier minted without a summary from member {m}"
            )
            for r, q in frontier.items():
                assert q <= summ.get(r, -1), (
                    f"minted frontier claims ({r},{q}) but member {m} "
                    f"only vouched for {summ}"
                )
        for m, summ in rec["summaries"].items():
            truth = self.true_vv.get(m, {})
            for r, q in summ.items():
                assert q <= truth.get(r, -1), (
                    f"summary from {m} claims ({r},{q}) beyond any vv "
                    f"that member ever held ({truth.get(r, -1)}): "
                    "stability header forged or tracker merged garbage"
                )
        self._check_gc_collection()

    def _check_gc_collection(self) -> None:
        """Collected-means-strictly-below, checked on every live node: any
        op the vv covers ABOVE the node's adopted frontier must still be
        present as a raw command — compaction may only ever fold what the
        frontier proves fleet-stable."""
        for s in self._alive():
            n = s.host.node
            vv = n.version_vector()
            f = dict(n._frontier)
            held = {(k[1], k[2]) for k in n._commands}
            for r, upto in vv.items():
                for q in range(f.get(r, -1) + 1, upto + 1):
                    assert (r, q) in held, (
                        f"slot {s.slot}: op ({r},{q}) above the adopted "
                        f"frontier {f.get(r, -1)} is missing from the raw "
                        "command map — an unstable op was collected"
                    )

    def _gc_final(self) -> None:
        """Post-heal coordinated GC: age the breakers shut with clean pull
        rounds, then one mint over the fully-converged, fully-fresh fleet
        — it MUST succeed, its frontier is the converged vv, and every
        node's raw command map must empty (the measured footprint win the
        report quotes against the shadow arm)."""
        for _ in range(6):  # > breaker backoff cap: every circuit closes
            self.plane.step += 1
            for src in self.slots:
                for dst in src.peer_slots:
                    t = src.transports[dst]
                    if not t.backed_off():
                        src.host.agent.pull_from(t)
        before = self.report.gc_mints
        self._drive_gc(self.plane.step)
        assert self.report.gc_mints == before + 1, (
            "post-heal GC round failed to mint despite a converged, "
            "fully-fresh fleet (tracker stalled on stale summaries?)"
        )
        vv = self.slots[0].host.node.version_vector()
        minted = self.slots[0].host.agent.stability.last_frontier
        assert minted == vv, (
            f"post-heal frontier {minted} != converged vv {vv}"
        )
        for s in self.slots:
            assert len(s.host.node._commands) == 0, (
                f"slot {s.slot} still retains "
                f"{len(s.host.node._commands)} raw commands after the "
                "full-vv fold"
            )

    # ---- --audit: planted-flip drive + the 1:1 detection oracle ----

    def _drive_audit(self, step: int) -> None:
        """Per-step audit drive: consult the ``op="state"`` pseudo-edge
        for every slot (the decide() coins are consulted unconditionally
        so the census matches the plant-free arm exactly), plant at most
        one silent flip per slot, convict it SYNCHRONOUSLY via the
        watchdog's store scrub (the 1:1 ``audit_scrub_drift`` accounting
        must not race a later fold's resync, which would adopt the
        corruption silently), pin it into a durable generation so no
        fallback restore can un-plant it, then tick every live
        watchdog."""
        from crdt_tpu_torch.obs.audit import plant_divergence
        from crdt_tpu_torch.utils import checkpoint as ckpt

        for s in self.slots:
            hits = self.plane.decide(str(s.slot), str(s.slot), "state")
            if ("flip" not in hits or not s.alive
                    or s.slot in self._audit_planted_slots):
                continue
            w = plant_divergence(s.host.node)
            if w is None:
                continue  # nothing folded yet; a later window coin retries
            self._audit_planted_slots.add(s.slot)
            # identity fields only: the flipped timestamps are wall-clock
            # LWW stamps, and the fault log must stay byte-identical
            # across same-seed runs (--replay-check); the full witness
            # (ts_before/ts_after) lives in audit_planted for the oracle
            self.plane.record("state_flip", slot=str(s.slot),
                              node=w["node"], key=w["key"])
            self.audit_planted.append({"step": step, "slot": s.slot, **w})
            drifted = s.host.agent.watchdog.scrub()
            assert any(d["plane"] == "host" for d in drifted), (
                f"planted flip on slot {s.slot} survived a store scrub: "
                "the digest recompute missed a corrupted winner row"
            )
            h = s.host
            ckpt.save_node_atomic(
                s.ckpt_dir, h.node, set_node=h.set_node,
                seq_node=h.seq_node, map_node=h.map_node,
                composite_node=h.composite_node,
                keyspace=h.keyspace, leases=h.leases,
            )
        for s in self._alive():
            s.host.agent.watchdog.evaluate()

    def _check_audit(self) -> None:
        """The post-heal audit oracle, in three movements.  (1) A final
        detection sweep — breakers aged shut, one fresh mint over the
        converged fleet, two exchange rounds at the new frontier, a
        watchdog tick everywhere — identical in both arms, so the wire
        census stays comparable.  (2) Plant arm: every planted flip is
        still live in its store (the durable-crash rule held), scrub
        convictions reconcile 1:1 against the planted-flip fault records,
        every ``divergence_detected`` pair implicates a planted node and
        every planted node is implicated, and an auto-postmortem bundle
        with the digest witnesses landed on disk.  (3) Plant-free arm:
        the machinery was demonstrably LIVE (every node compared digests
        at the shared post-heal frontier and reports AUDIT_OK) yet raised
        ZERO drift or divergence events — no false positives under the
        full fault schedule."""
        import tarfile

        from crdt_tpu_torch.obs import audit as audit_mod

        for _ in range(6):  # > breaker backoff cap: every circuit closes
            self.plane.step += 1
            for src in self.slots:
                for dst in src.peer_slots:
                    t = src.transports[dst]
                    if not t.backed_off():
                        src.host.agent.pull_from(t)
        before = self.report.gc_mints
        self._drive_gc(self.plane.step)
        assert self.report.gc_mints == before + 1, (
            "post-heal audit mint failed despite a converged, fully-fresh "
            "fleet (tracker stalled on stale summaries?)"
        )
        for _ in range(2):  # exchange digests at the fresh frontier
            self.plane.step += 1
            for src in self.slots:
                for dst in src.peer_slots:
                    src.host.agent.pull_from(src.transports[dst])
        for s in self.slots:
            s.host.agent.watchdog.evaluate()

        drifts: List[Tuple[int, Dict[str, Any]]] = []
        divs: List[Tuple[int, Dict[str, Any]]] = []
        posts: List[Tuple[int, Dict[str, Any]]] = []
        for s in self.slots:
            for e in read_jsonl(s.event_log_path):
                ev = e.get("event")
                if ev == "audit_scrub_drift":
                    drifts.append((s.slot, e))
                elif ev == "divergence_detected":
                    divs.append((s.slot, e))
                elif ev == "audit_postmortem":
                    posts.append((s.slot, e))
        self.report.audit_planted = len(self.audit_planted)
        self.report.audit_drifts = len(drifts)
        self.report.audit_divergences = len(divs)
        self.report.wire_census = dict(sorted(
            self.plane.decisions.items()))
        bundles = [pathlib.Path(s.ckpt_dir) / f"postmortem-{self.seed}.tar.gz"
                   for s in self.slots]

        if self.audit_plant:
            assert self.audit_planted, (
                f"seed {self.seed}: the flip window produced zero planted "
                "flips — widen the window or raise p"
            )
            planted = {p["slot"] for p in self.audit_planted}
            for p in self.audit_planted:
                e = self.slots[p["slot"]].host.node._summary.get(p["key"])
                assert e is not None and int(e["ts"]) == p["ts_after"], (
                    f"planted corruption on slot {p['slot']} key "
                    f"{p['key']!r} was silently healed mid-run "
                    f"(summary now {e}) — the durable-crash rule leaked"
                )
            assert len(drifts) == len(self.audit_planted), (
                f"{len(self.audit_planted)} planted flip(s) but "
                f"{len(drifts)} audit_scrub_drift event(s): the 1:1 "
                "conviction accounting drifted"
            )
            assert {sl for sl, _ in drifts} == planted, (
                f"scrub convictions on slots {sorted(sl for sl, _ in drifts)} "
                f"!= planted slots {sorted(planted)}"
            )
            assert divs, "planted divergence was never flagged by any peer"
            url_slot = {self._url_of(s): s.slot for s in self.slots}
            implicated: set = set()
            for sl, e in divs:
                pair = {sl if side == "local" else url_slot.get(side, side)
                        for side in (e.get("a"), e.get("b"))}
                assert pair & planted, (
                    f"divergence_detected between clean nodes only: {e}"
                )
                implicated |= pair & planted
            assert implicated == planted, (
                f"divergence events implicate planted slots "
                f"{sorted(implicated)} but the driver planted "
                f"{sorted(planted)}"
            )
            found = [b for b in bundles if b.exists()]
            assert found and posts, (
                "divergence latched but no auto-postmortem bundle landed"
            )
            with tarfile.open(found[0]) as tf:
                names = tf.getnames()
            assert any(n.endswith("audit_witnesses.json") for n in names), (
                f"postmortem bundle {found[0]} carries no digest "
                f"witnesses: {names}"
            )
            self.report.audit_postmortems = len(found)
            for sl in planted:
                wd = self.slots[sl].host.agent.watchdog
                assert wd.state == audit_mod.AUDIT_DIVERGED, (
                    f"planted slot {sl} watchdog state {wd.state} != "
                    "AUDIT_DIVERGED after the final sweep"
                )
        else:
            assert not drifts and not divs and not posts, (
                f"plant-free audit arm raised events: drifts={drifts} "
                f"divergences={divs} — false positive"
            )
            for b in bundles:
                assert not b.exists(), (
                    f"plant-free arm wrote a postmortem bundle: {b}"
                )
            for s in self.slots:
                wd = s.host.agent.watchdog
                assert wd.state == audit_mod.AUDIT_OK, (
                    f"slot {s.slot} watchdog state {wd.state} != AUDIT_OK "
                    "after the final sweep: the audit plane never compared "
                    "digests (machinery dead, oracle vacuous)"
                )

    # ---- --strong: post-heal recovery + event reconciliation ----

    def _check_strong_recovery(self) -> None:
        """After heal, strong operations must come back OUTRIGHT: age the
        breakers shut, then a linearizable read, a CAS, and a read-back
        on slot 0 — any ConsistencyUnavailable here is a recovery bug."""
        for _ in range(6):
            self.plane.step += 1
            self._pin_clocks(self.plane.step)
            for src in self.slots:
                for dst in src.peer_slots:
                    t = src.transports[dst]
                    if not t.backed_off():
                        src.host.agent.pull_from(t)
        slot = self.slots[0]
        cons = slot.host.consistency
        key = self.STRONG_KEYS[0]
        val = cons.read(key, level="linearizable")
        self._audit_strong(key, val, op="recovery_read")
        self.strong_gen += 1
        new = f"g{self.strong_gen}"
        token = cons.cas(key, val, new)
        (rid, seq), = token.items()
        self._journal_at(rid, seq, "strong", key, new)
        self.strong_committed[key] = new
        self.strong_pending[key] = set()
        self.strong_view[key] = new
        got = cons.read(key, level="linearizable")
        assert got == new, (
            f"post-heal CAS wrote {new!r} but the linearizable read-back "
            f"returned {got!r}"
        )

    def _check_strong_provenance(self) -> None:
        """The never-silent contract for strong ops, audited 1:1 like the
        shed ledger: every ConsistencyUnavailable the driver caught must
        appear as a ``consistency_unavailable`` event in some node's black
        box — same total, same indeterminate split.  And a strong soak
        that never lost a quorum (or never completed an op) tested
        nothing, so both counts must be positive."""
        events = []
        for s in self.slots:
            events.extend(e for e in read_jsonl(s.event_log_path)
                          if e.get("event") == "consistency_unavailable")
        assert len(events) == self.report.strong_unavailable, (
            f"driver caught {self.report.strong_unavailable} "
            f"ConsistencyUnavailable but the black boxes recorded "
            f"{len(events)} consistency_unavailable events"
        )
        ind = sum(1 for e in events if e.get("indeterminate"))
        assert ind == self.report.strong_indeterminate, (
            f"{self.report.strong_indeterminate} indeterminate CAS "
            f"outcomes vs {ind} indeterminate events"
        )
        assert self.report.strong_unavailable > 0, (
            "strong soak never lost a quorum: faults too mild to pin the "
            "503 posture"
        )
        assert self.report.strong_ok > 0, (
            "strong soak never completed a strong op: quorum settings or "
            "timeouts dead"
        )

    def _check_fence_decisions(self) -> None:
        """The fencing-token oracle: for every (lease slot, fence epoch),
        at most ONE node ever announced a quorum-acked CAS decision.  A
        ``cas_commit`` event is emitted by the deciding node into its OWN
        black box, so the emitting log file IS the decider's identity —
        two different log files sharing a (slot, fence) pair would mean a
        zombie and its successor both committed under one epoch, exactly
        what fencing exists to forbid.  (One decider repeating a pair is
        legal: a lease covers many CAS ops.)  In crash-coordinator mode
        the scenario must have fired: fenced commits observed, and every
        audited zombie push left a ``cas_fenced_reject`` somewhere."""
        deciders: Dict[Tuple[str, int], set] = {}
        commits = rejects = 0
        for s in self.slots:
            for e in read_jsonl(s.event_log_path):
                ev = e.get("event")
                if ev == "cas_commit":
                    commits += 1
                    for slot_s, fence in (e.get("fences") or {}).items():
                        deciders.setdefault(
                            (slot_s, int(fence)), set()).add(s.slot)
                elif ev == "cas_fenced_reject":
                    rejects += 1
        dup = {k: sorted(v) for k, v in deciders.items() if len(v) > 1}
        assert not dup, (
            f"split-brain decisions: multiple nodes committed under the "
            f"same (lease slot, fence epoch): {dup} — fencing failed to "
            "serialize coordinators"
        )
        self.report.cas_commits = commits
        self.report.fenced_rejects = rejects
        if self.crash_coordinator:
            assert commits > 0, (
                "crash-coordinator soak never quorum-committed a fenced "
                "CAS: the lease plane was never exercised"
            )
            if self.report.zombie_attempts:
                assert rejects > 0, (
                    f"{self.report.zombie_attempts} zombie pushes audited "
                    "but no cas_fenced_reject event in any black box"
                )

    # ---- heal phase: recovery provenance + convergence + oracle ----

    def _plant_and_recover(self) -> None:
        """The pinned recovery scenario: two clean generations, tear the
        newest, reboot — the node must quarantine it and restore the
        previous one, with the whole story in its JSONL black box."""
        slot = self.slots[-1]
        if not slot.alive:
            slot.boot()
            self.report.reboots += 1
        h = slot.host
        slot.disk.save(slot.ckpt_dir, h.node, set_node=h.set_node,
                       seq_node=h.seq_node, map_node=h.map_node,
                       composite_node=h.composite_node)
        # this write rides ONLY the (about to be torn) newest generation
        # and is never gossiped: the fallback restore must drop it, and
        # the prefix oracle must see the fleet vv stop just short of it
        rid = h.node.rid
        seq = self.writes.get(rid, 0)
        if h.node.add_command({f"k{rid}-{seq}": f"v{rid}-{seq}"}):
            self.writes[rid] = seq + 1
            self.report.writes += 1
            self._journal(rid, "kv", f"k{rid}-{seq}", f"v{rid}-{seq}")
        snap_b, _ = slot.disk.save(
            slot.ckpt_dir, h.node, set_node=h.set_node,
            seq_node=h.seq_node, map_node=h.map_node,
            composite_node=h.composite_node,
        )
        self.report.checkpoints += 2
        slot.crash(durable=False)
        torn = plant_corruption(
            slot.ckpt_dir, rng=random.Random(f"nemesis-plant:{self.seed}"))
        assert torn == snap_b, (torn, snap_b)
        slot.boot()
        self.report.crashes += 1
        self.report.reboots += 1
        recs = read_jsonl(slot.event_log_path)
        b_name = pathlib.Path(snap_b).name
        quarantined = [e for e in recs
                       if e.get("event") == "snapshot_quarantine"
                       and e.get("snap") == b_name]
        assert quarantined, (
            f"planted corruption in {b_name} was restored without a "
            "quarantine event"
        )
        restores = [e for e in recs if e.get("event") == "snapshot_restore"]
        last = restores[-1] if restores else None
        assert last and last.get("fallback") and last.get("verified"), (
            f"expected a verified fallback restore after tearing {b_name}, "
            f"got {last}"
        )
        quark = sorted(pathlib.Path(slot.ckpt_dir).glob("quarantine-*"))
        assert quark, "quarantined snapshot dir missing from disk"

    def _fleet_converged(self) -> bool:
        states = []
        for s in self.slots:
            states.append((s.host.node.get_state(),
                           s.host.node.version_vector()))
        if any(st is None for st, _ in states):
            return False
        if any(t.pending_redelivery()
               for s in self.slots for t in s.transports.values()):
            return False
        if not all(st == states[0] for st in states[1:]):
            return False
        if self.composite:
            # intern orders differ per node: fingerprint() is the
            # canonical comparable form (compositenode docstring)
            fps = [s.host.composite_node.fingerprint() for s in self.slots]
            if not all(fp == fps[0] for fp in fps[1:]):
                return False
        if self.multitenant:
            # per-shard convergence IS fleet convergence (deterministic
            # routing): every shard's (state, vv) must match across nodes
            for i in range(self.slots[0].host.keyspace.n_shards):
                views = [(s.host.keyspace.shards[i].get_state(),
                          s.host.keyspace.shards[i].version_vector())
                         for s in self.slots]
                if any(st is None for st, _ in views):
                    return False
                if not all(v == views[0] for v in views[1:]):
                    return False
        return True

    def _converge(self, max_rounds: int) -> None:
        for r in range(1, max_rounds + 1):
            self.plane.step += 1  # breakers keep aging; nemesis stays off
            for src in self.slots:
                for dst in src.peer_slots:
                    t = src.transports[dst]
                    if t.backed_off():
                        continue
                    src.host.agent.pull_from(t)
                    if self.composite:
                        src.host.agent.composite_pull(t)
                    if self.multitenant:
                        src.host.agent.ks_pull(t)
                health.sample_peer_circuits(
                    src.host.node.metrics.registry, str(src.slot),
                    src.transports.values(),
                )
            if self._fleet_converged():
                self.report.heal_rounds = r
                return
        raise AssertionError(
            f"fleet failed to converge within {max_rounds} rounds after "
            f"heal (seed {self.seed})"
        )

    def _check_prefix_oracle_strong(self) -> None:
        """Strong-mode prefix oracle: CAS mints share each rid's seq space
        with plain writes, so the expected state is a walk of the per-rid
        mint journal up to the vv — unique kv keys fold directly, shared
        strong registers resolve by global mint order (pinned clocks make
        LWW order == mint order)."""
        state = self.slots[0].host.node.get_state()
        vv = self.slots[0].host.node.version_vector()
        expected: Dict[str, str] = {}
        strong_winner: Dict[str, Tuple[int, str]] = {}
        for rid, entries in sorted(self.minted.items()):
            upto = vv.get(rid, -1)
            assert upto < len(entries), (
                f"fleet vv claims seq {upto} for writer {rid}, which only "
                f"minted {len(entries)} ops (ghost writes)"
            )
            for i, (order, kind, key, val) in enumerate(entries):
                if i > upto:
                    if kind == "kv":
                        assert key not in state, (
                            f"{key} present above the vv prefix (seq {i} "
                            f"> {upto}): contiguity broken"
                        )
                    continue
                if kind == "kv":
                    expected[key] = val
                elif order > strong_winner.get(key, (-1, ""))[0]:
                    strong_winner[key] = (order, val)
        for key, (_, val) in strong_winner.items():
            expected[key] = val
        assert state == expected, (
            "converged state != vv-prefix fold of the mint journal: "
            f"missing={sorted(set(expected) - set(state))[:5]} "
            f"extra={sorted(set(state) - set(expected))[:5]} "
            f"wrong={sorted(k for k in set(state) & set(expected) if state[k] != expected[k])[:5]}"
        )
        for s in self.slots:
            rid = s.host.node.rid
            if rid in self.minted:
                assert vv.get(rid, -1) == len(self.minted[rid]) - 1, (
                    f"live writer {rid} lost writes: vv={vv.get(rid)} "
                    f"journal={len(self.minted[rid])}"
                )
        self.report.final_keys = len(state)

    def _check_prefix_oracle(self) -> None:
        if self.strong:
            self._check_prefix_oracle_strong()
            return
        state = self.slots[0].host.node.get_state()
        vv = self.slots[0].host.node.version_vector()
        expected = {}
        for rid, count in sorted(self.writes.items()):
            upto = vv.get(rid, -1)
            assert upto < count, (
                f"fleet vv claims seq {upto} for writer {rid}, which only "
                f"minted {count} ops (ghost writes)"
            )
            for seq in range(count):
                key = f"k{rid}-{seq}"
                if seq <= upto:
                    expected[key] = f"v{rid}-{seq}"
                else:
                    assert key not in state, (
                        f"{key} present above the vv prefix (seq {seq} > "
                        f"{upto}): contiguity broken"
                    )
        assert state == expected, (
            "converged state != vv-prefix fold of the write ledger: "
            f"missing={sorted(set(expected) - set(state))[:5]} "
            f"extra={sorted(set(state) - set(expected))[:5]}"
        )
        # every CURRENT incarnation survived to the heal, so none of its
        # writes may have been lost
        for s in self.slots:
            rid = s.host.node.rid
            if rid in self.writes:
                assert vv.get(rid, -1) == self.writes[rid] - 1, (
                    f"live writer {rid} lost writes: vv={vv.get(rid)} "
                    f"ledger={self.writes[rid]}"
                )
        self.report.final_keys = len(state)

    def _check_quarantine_provenance(self) -> None:
        """The black box must account for every quarantine: snapshot
        quarantine events match the quarantine- dirs on disk 1:1, and
        every gossip corruption that got through the wire shows up as a
        payload_quarantine event (the loop survived it)."""
        gossip_corrupts = sum(
            1 for rec in self.plane.log
            if rec["fault"] == "corrupt"
            and rec.get("op") in ("gossip", "composite_gossip")
        )
        payload_q = snap_q = 0
        for s in self.slots:
            recs = read_jsonl(s.event_log_path)
            payload_q += sum(
                1 for e in recs if e.get("event") == "payload_quarantine")
            slot_snap_q = sum(
                1 for e in recs if e.get("event") == "snapshot_quarantine")
            on_disk = len(list(
                pathlib.Path(s.ckpt_dir).glob("quarantine-*")))
            assert slot_snap_q == on_disk, (
                f"slot {s.slot}: {slot_snap_q} snapshot_quarantine events "
                f"vs {on_disk} quarantined dirs on disk"
            )
            snap_q += slot_snap_q
        assert payload_q == gossip_corrupts, (
            f"{gossip_corrupts} corrupt gossip payloads were injected but "
            f"{payload_q} payload_quarantine events were logged"
        )
        self.report.payload_quarantines = payload_q
        self.report.snapshot_quarantines = snap_q

    def _check_shed_provenance(self) -> None:
        """The never-silent contract, audited 1:1: every ShedError the
        driver caught must appear as an ``ingest_shed`` record in some
        node's JSONL black box — same shed count, same total op count.
        Counted from the event logs, NOT the metrics registries: logs
        persist across reboots, registries are born empty with each
        incarnation.  And an overload run that never actually shed
        tested nothing, so zero sheds is itself a failure."""
        shed_events = []
        for s in self.slots:
            shed_events.extend(
                e for e in read_jsonl(s.event_log_path)
                if e.get("event") == "ingest_shed")
        assert self.sheds_client > 0, (
            "overload soak never tripped the high-water mark: bursts too "
            "small or shed policy dead"
        )
        assert len(shed_events) == self.sheds_client, (
            f"client saw {self.sheds_client} sheds but the black boxes "
            f"recorded {len(shed_events)} ingest_shed events"
        )
        ops_logged = sum(int(e.get("n_ops", 0)) for e in shed_events)
        assert ops_logged == self.shed_ops_client, (
            f"client had {self.shed_ops_client} ops turned away but the "
            f"black boxes account for {ops_logged}"
        )
        page_q = sum(
            1 for s in self.slots for e in read_jsonl(s.event_log_path)
            if e.get("event") == "ingest_page_quarantine")
        assert page_q == self.pages_corrupt_client, (
            f"{self.pages_corrupt_client} corrupt pages were sent but "
            f"{page_q} ingest_page_quarantine events were logged"
        )
        self.report.sheds = self.sheds_client
        self.report.shed_ops = self.shed_ops_client
        self.report.page_quarantines = page_q

    def _check_idempotence(self) -> None:
        """Duplicate + reorder delivery against the CONVERGED fleet: a
        full payload applied twice, then an OLDER delta applied after it,
        must leave state and vv byte-identical (join idempotence +
        monotonicity — the laws the message faults hammered all run)."""
        a, b = self.slots[0].host.node, self.slots[1].host.node
        snap = (json.dumps(a.get_state(), sort_keys=True),
                a.version_vector())
        full = b.gossip_payload(since=None)
        a.receive(full)
        a.receive(full)  # duplicate delivery
        half_vv = {r: s // 2 for r, s in b.version_vector().items()}
        a.receive(b.gossip_payload(since=half_vv))  # old-after-new
        after = (json.dumps(a.get_state(), sort_keys=True),
                 a.version_vector())
        assert after == snap, (
            "duplicate/reorder delivery mutated a converged node: "
            f"{snap} -> {after}"
        )
        if self.composite:
            # same laws for the composite: replaying a peer's full state
            # twice against the converged fleet must be a no-op
            ca = self.slots[0].host.composite_node
            cb = self.slots[1].host.composite_node
            fp = ca.fingerprint()
            payload = cb.gossip_payload()
            ca.receive(payload)
            ca.receive(payload)
            assert ca.fingerprint() == fp, (
                "duplicate composite delivery mutated a converged node"
            )

    # ---- --multitenant: per-tenant isolation oracle + shard-local GC ----

    def _check_multitenant_oracle(self) -> None:
        """Per-tenant isolation, audited 1:1 on the CONVERGED fleet:

        * every tenant's view on every node is bit-exact against the
          driver's admission ledger (what was admitted converged; what
          was shed or quarantined left no trace);
        * the noisy tenant shed ALONE: every ingest_shed event in every
          black box carries its tenant label and the tenant-lane mark,
          and the counts (and op totals) match the client's 1:1 — same
          for corrupt-page quarantines;
        * shard-scoped join laws: replaying a peer shard's full payload
          twice into its converged twin mutates nothing.
        """
        from crdt_tpu_torch.keyspace import TENANT_LANE

        tenants = (*self.MT_TENANTS, self.MT_NOISY)
        for s in self.slots:
            ks = s.host.keyspace
            for tenant in tenants:
                got = ks.tenant_state(tenant)
                want = self.mt_expected[tenant]
                assert got == want, (
                    f"slot {s.slot} tenant {tenant!r}: converged view != "
                    f"admission ledger: "
                    f"missing={sorted(set(want) - set(got))[:5]} "
                    f"extra={sorted(set(got) - set(want))[:5]} "
                    f"wrong={sorted(k for k in set(got) & set(want) if got[k] != want[k])[:5]}"
                )
        a, b = self.slots[0].host.keyspace, self.slots[1].host.keyspace
        for i in range(a.n_shards):
            snap = (json.dumps(a.shards[i].get_state(), sort_keys=True),
                    a.shards[i].version_vector())
            full = b.gossip_payload(i, None)
            a.receive(i, full)
            a.receive(i, full)  # duplicate delivery
            after = (json.dumps(a.shards[i].get_state(), sort_keys=True),
                     a.shards[i].version_vector())
            assert after == snap, (
                f"duplicate shard-{i} delivery mutated a converged "
                f"keyspace: {snap} -> {after}"
            )
        shed_events, quar_events = [], []
        for s in self.slots:
            for e in read_jsonl(s.event_log_path):
                if e.get("event") == "ingest_shed":
                    shed_events.append(e)
                elif e.get("event") == "ingest_page_quarantine":
                    quar_events.append(e)
        noisy_sheds = [e for e in shed_events
                       if e.get("tenant") == self.MT_NOISY
                       and e.get("lane") == TENANT_LANE
                       and e.get("high_water") == self.MT_NOISY_QUOTA]
        assert len(shed_events) == len(noisy_sheds), (
            f"a well-behaved tenant shed: {len(shed_events)} ingest_shed "
            f"events but only {len(noisy_sheds)} are noisy-tenant quota "
            f"sheds — isolation broken: "
            f"{[e for e in shed_events if e not in noisy_sheds][:3]}"
        )
        assert len(noisy_sheds) == self.mt_sheds_client, (
            f"noisy client saw {self.mt_sheds_client} quota sheds but the "
            f"black boxes recorded {len(noisy_sheds)}"
        )
        ops_logged = sum(int(e.get("n_ops", 0)) for e in noisy_sheds)
        assert ops_logged == self.mt_shed_ops_client, (
            f"noisy client had {self.mt_shed_ops_client} ops turned away "
            f"but the black boxes account for {ops_logged}"
        )
        noisy_quar = [e for e in quar_events
                      if e.get("tenant") == self.MT_NOISY]
        assert len(quar_events) == len(noisy_quar), (
            f"page quarantine without noisy-tenant provenance: "
            f"{[e for e in quar_events if e not in noisy_quar][:3]}"
        )
        assert len(noisy_quar) == self.mt_corrupt_client, (
            f"{self.mt_corrupt_client} corrupt pages were sent but "
            f"{len(noisy_quar)} tenant-labeled quarantine events logged"
        )
        # a multitenant soak where the noisy tenant never tripped its
        # slice (or never corrupted a page) pinned nothing
        assert self.mt_sheds_client > 0, (
            "noisy tenant never tripped its quota slice: bursts too small "
            "or tenant shed policy dead"
        )
        assert self.mt_corrupt_client > 0, (
            "noisy tenant never quarantined a page: corruption arm dead"
        )
        total_keys = sum(len(v) for v in self.mt_expected.values())
        for st in a.shard_stats():
            if total_keys >= 32:
                assert st["keys"] > 0, (
                    f"a shard holds zero keys over a {total_keys}-key "
                    f"workload: routing never spread — {a.shard_stats()}"
                )
        self.report.mt_tenants = len(tenants)
        self.report.mt_shards = a.n_shards
        self.report.mt_keys = total_keys
        self.report.mt_sheds = self.mt_sheds_client
        self.report.mt_shed_ops = self.mt_shed_ops_client
        self.report.mt_page_quarantines = self.mt_corrupt_client

    def _mt_gc_final(self) -> None:
        """Post-heal shard-local stability GC: age the breakers shut with
        clean rounds (main + keyspace pulls feed every shard tracker a
        fresh summary from every member), then one coordinator GC round —
        every shard must mint, each minted frontier IS that shard's
        converged vv, and every node's every shard op log must empty."""
        for _ in range(6):  # > breaker backoff cap: every circuit closes
            self.plane.step += 1
            for src in self.slots:
                for dst in src.peer_slots:
                    t = src.transports[dst]
                    if not t.backed_off():
                        src.host.agent.pull_from(t)
                        src.host.agent.ks_pull(t)
        coord = self.slots[0]
        folded = coord.host.agent.ks_gc_once(step=int(self.plane.step))
        ks = coord.host.keyspace
        assert len(folded) == ks.n_shards, (
            f"post-heal keyspace GC folded only {sorted(folded)} of "
            f"{ks.n_shards} shards (stalled trackers on a converged, "
            "fully-fresh fleet?)"
        )
        for i in range(ks.n_shards):
            vv = ks.shards[i].version_vector()
            assert folded[i] == vv, (
                f"shard {i}: minted frontier {folded[i]} != converged "
                f"vv {vv}"
            )
        for s in self.slots:
            for i, shard in enumerate(s.host.keyspace.shards):
                assert len(shard._commands) == 0, (
                    f"slot {s.slot} shard {i} retains "
                    f"{len(shard._commands)} raw commands after the "
                    "full-vv fold"
                )

    def _rs_finalize(self) -> None:
        """Post-heal reshard completion: any slot still carrying the
        old epoch (dead through cutover day, or rebooted from a
        pre-cutover ledger at heal) cuts over now, BEFORE convergence —
        a cutover folds only local evidence, and the per-node re-minted
        winner sets union through ordinary post-cutover anti-entropy.
        Then the topology gate: one epoch, one shard map, idle machines
        everywhere."""
        for s in self.slots:
            if s.host.keyspace.epoch == 0:
                self._rs_cutover_one(s)
        for s in self.slots:
            ks = s.host.keyspace
            assert ks.epoch == 1 and ks.n_shards == self.rs_target \
                and ks.reshard.phase == "idle", (
                    f"slot {s.slot} never finished the reshard: "
                    f"{ks.reshard.status()}"
                )

    def _check_reshard_oracle(self) -> None:
        """The reshard acceptance gates, on the CONVERGED fleet:

        * disjoint post-cutover ownership — on every node, every key
          lives at exactly the one shard the new router assigns it (no
          key at two shards; ledger equality across S -> S' is already
          pinned by _check_multitenant_oracle);
        * 409 provenance 1:1 — the staggered cutover's predicted fence
          count equals both the client-side and the serve-side
          ``ks_reshard_fence`` events (the client breaks its round on
          the first fenced shard, so both sides log exactly once per
          forced stale pull);
        * quarantine provenance 1:1 — every corrupt migration slice
          the client saw bounce as a 400 has exactly one
          ``ks_reshard_quarantine`` event, no quarantine appears out
          of thin air, and corrupt ks_migrate fault records bound the
          total (a corrupted slice toward a dead peer never arrives).
        """
        from crdt_tpu_torch.keyspace import split_qualified
        from crdt_tpu_torch.keyspace.routing import route_key

        for s in self.slots:
            ks = s.host.keyspace
            seen: Dict[str, int] = {}
            for i in range(ks.n_shards):
                for qkey in ks.shards[i].get_state():
                    assert qkey not in seen, (
                        f"slot {s.slot}: key {qkey!r} lives at shards "
                        f"{seen[qkey]} and {i} after cutover"
                    )
                    seen[qkey] = i
                    tenant, key = split_qualified(qkey)
                    own = ks.router.owner_index(route_key(tenant, key))
                    assert own == i, (
                        f"slot {s.slot}: key {qkey!r} held at shard {i} "
                        f"but the post-cutover router owns it at {own}"
                    )
        client = serve = quar = 0
        for s in self.slots:
            for e in read_jsonl(s.event_log_path):
                ev = e.get("event")
                if ev == "ks_reshard_fence":
                    if e.get("role") == "client":
                        client += 1
                    else:
                        serve += 1
                elif ev == "ks_reshard_quarantine":
                    quar += 1
        assert self.rs_fences_pred > 0, (
            "the staggered cutover never produced a fenced pull: the "
            "epoch fence went unexercised"
        )
        assert client == self.rs_fences_pred, (
            f"predicted {self.rs_fences_pred} fenced pulls but "
            f"{client} client-side ks_reshard_fence events were logged"
        )
        assert serve == self.rs_fences_pred, (
            f"predicted {self.rs_fences_pred} fenced pulls but "
            f"{serve} serve-side ks_reshard_fence events were logged"
        )
        assert quar == self.rs_quar_client, (
            f"clients saw {self.rs_quar_client} migration slices bounce "
            f"as quarantined but {quar} ks_reshard_quarantine events "
            "were logged"
        )
        corrupts = sum(
            1 for rec in self.plane.log
            if rec["fault"] == "corrupt" and rec.get("op") == "ks_migrate")
        assert quar <= corrupts, (
            f"{quar} migration quarantines but only {corrupts} corrupt "
            "ks_migrate faults were injected: a clean slice was refused"
        )
        assert quar > 0, (
            "no corrupt migration slice ever reached a receiver: the "
            "quarantine path went unexercised"
        )
        self.report.rs_epoch = 1
        self.report.rs_shards_from = self.rs_shards0
        self.report.rs_shards_to = self.rs_target
        self.report.rs_fences = client
        self.report.rs_quarantines = quar

    def _check_mt_restores(self) -> None:
        """Crash-recovery provenance for the keyspace tier: every death
        in this arm is a durable crash whose atomic save is the newest
        generation at reboot, so every ``snapshot_restore`` must be a
        verified, non-fallback restore carrying the shard files — and
        at least one must have happened if anything rebooted (a reboot
        that silently came up empty would pass convergence via
        anti-entropy while voiding the recovery claim)."""
        restores = []
        for s in self.slots:
            for e in read_jsonl(s.event_log_path):
                if e.get("event") == "snapshot_restore":
                    restores.append(e)
        for e in restores:
            assert e.get("verified") is True, (
                f"unverified restore in a durable-crash arm: {e}")
            assert e.get("fallback") is False, (
                f"fallback restore in a durable-crash arm (the atomic "
                f"crash save must be the newest generation): {e}")
            assert int(e.get("ks_shards", 0)) >= 1, (
                f"restore carried no keyspace shard files: {e}")
        if self.report.reboots:
            assert restores, (
                f"{self.report.reboots} reboot(s) but no "
                "snapshot_restore event: the keyspace tier never "
                "actually recovered from a checkpoint"
            )
        self.report.mt_restores = len(restores)

    def heal_and_check(self, max_rounds: int = 80) -> NemesisReport:
        self.plane.heal()
        for s in self.slots:
            if not s.alive:
                s.boot()
                self.report.reboots += 1
        if self.reshard:
            # stragglers first: every node must be on the new epoch
            # before the convergence rounds gossip across the fleet
            self._rs_finalize()
        if not self.multitenant:
            # the plant scenario ends in an AMNESIA crash (durable=False)
            # on purpose — its fallback restore deliberately drops never-
            # snapshotted writes, which would void the per-tenant
            # admission ledger.  Multitenant crash coverage rides the
            # action table instead (durable crashes + verified restores,
            # audited in _check_mt_restores).
            self._plant_and_recover()
        if self.strong:
            # advance every node (including just-rebooted slots, whose
            # _BandClock was born at the plane's current step) into one
            # shared heal band above the whole run
            self._pin_clocks(self.steps)
            # age every lease past its duration: whatever grants the run
            # left behind (including a zombie's own stale view) expire,
            # so the recovery CAS can re-acquire outright — a persisted
            # fence floor plus the taught-fence retry does the rest
            for s in self.slots:
                s.plane_time.t += self.config.lease_duration_s + 1.0
        self._converge(max_rounds)
        if self.strong:
            self._check_strong_recovery()
        if self.gc:
            self._gc_final()
        if self.audit:
            # post-_converge on purpose: the convergence rounds already
            # exchanged digests at the run's frontiers, so the detection
            # sweep in here only has to pin the FINAL shared frontier
            self._check_audit()
        if self.multitenant:
            self._check_multitenant_oracle()
            if self.reshard:
                self._check_reshard_oracle()
            self._check_mt_restores()
            self._mt_gc_final()
            # fleet SLO rollup over the converged fleet, then the two
            # observability gates it feeds: per-tenant propagation
            # coverage (the MT mirror of --assemble-check) and the
            # slo_breach <-> ingest_shed 1:1 reconciliation
            self._fleet_rollup(emit_events=True)
            if not self.reshard:
                # the cutover rebirths planes past the original
                # per-shard birth-ledger list, so tenant propagation
                # lag is not derivable across the epoch; the reshard
                # oracle's ledger equality is the stronger gate there
                self._check_mt_propagation()
            self._check_slo_accounting()
        self._check_prefix_oracle()
        self._check_idempotence()
        self._check_quarantine_provenance()
        if self.strong:
            self._check_strong_provenance()
            self._check_fence_decisions()
        if self.overload:
            self._check_shed_provenance()
        # two-arm comparison inputs, captured on EVERY run: the --gc
        # shadow arm is diffed bit-for-bit against these
        self.report.state_json = json.dumps(
            self.slots[0].host.node.get_state(), sort_keys=True)
        self.report.final_vv = dict(self.slots[0].host.node.version_vector())
        self.report.writes_ledger = dict(self.writes)
        self.report.gc_retained = sum(
            len(s.host.node._commands) for s in self.slots)
        if self.composite:
            self.report.final_composite_keys = len(
                self.slots[0].host.composite_node.items())
        self.report.fault_counts = self.plane.counts()
        self.report.propagation = propagation_summary(
            *(s.host.node.metrics.registry for s in self.slots)
        )
        self._check_union_engine_health()
        if self.assemble_check:
            self._check_assembly()
        return self.report

    def _check_union_engine_health(self) -> None:
        """Set-union engine gates, ridden by EVERY soak: (1) the strict
        join layer saw ZERO capacity truncations over the whole faulted
        run (strict joins refuse loudly; a silent drop is a lost-write
        bug); (2) the engine-dispatch counter is live on a served
        /metrics scrape — auto-dispatch must stay observable, not
        inferred from timings."""
        import urllib.request

        from crdt_tpu_torch.ops import union_engine

        delta = union_engine.truncation_count() - self._truncations_at_start
        assert delta == 0, (
            f"{delta} set-union truncation(s) recorded during the soak; "
            "strict joins must refuse, never drop"
        )
        slot = next(s for s in self.slots if s.alive)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{slot.port}/metrics", timeout=10) as res:
            body = res.read().decode()
        assert "crdt_union_path_total" in body, (
            "crdt_union_path_total missing from the served /metrics scrape"
        )
        # the lease sampler rides the same scrape in EVERY mode: the
        # per-slot state and fence-epoch gauges are scrape-fresh (set by
        # a render callback), so a served host without them means the
        # coordinator plane went unobservable
        for gauge in ("crdt_lease_state", "crdt_lease_fence_epoch"):
            assert gauge in body, (
                f"{gauge} missing from the served /metrics scrape: lease "
                "sampler not wired"
            )

    def _fleet_rollup(self, emit_events: bool = False):
        """Fold every live member's Prometheus exposition into the fleet
        SLO view (obs/fleet) — the same code path as ``GET /fleet`` and
        ``python -m crdt_tpu_torch.obs fleet``.  With ``emit_events`` the SLO
        threshold crossings land as first-class ``slo_breach`` records
        in the first live node's black box (so the postmortem and the
        reconciliation both see them)."""
        from crdt_tpu_torch.obs import fleet as fleet_lib

        texts = {}
        for s in self.slots:
            if not s.alive:
                continue
            h = s.host
            texts[str(h.node.rid)] = health.render_node_metrics(
                h.node, agent=h.agent, ingest=h.ingest,
                stability=getattr(h.agent, "stability", None),
                keyspace=h.keyspace, ks_door=h.ks_door, leases=h.leases)
        if not texts:
            return None
        events = None
        if emit_events:
            live = next((s for s in self.slots if s.alive), None)
            if live is not None:
                events = live.host.node.events
        self._fleet_report = fleet_lib.fleet_from_texts(
            texts, events=events)
        return self._fleet_report

    def _check_mt_propagation(self, min_coverage: float = 0.95) -> None:
        """Per-tenant flight-recorder coverage gate: every tenant's
        admitted ops must show up as tenant-labeled propagation
        observations on >= min_coverage of the ``ops x (nodes-1)``
        expected remote visibilities.  Counted from the PERSISTED
        ``op_visible`` events — the vv-delta derivation is exactly-once
        and durable crashes flush the vv with the planes, so the JSONL
        black boxes stay exact across reboots, where the scrape-based
        rollup coverage cannot (a dead incarnation takes its registry,
        and its admitted-op counters, with it).  A shortfall is MISSING
        provenance and an excess is a duplicate-counting bug, and both
        fail loudly."""
        observed: Dict[str, int] = {}
        for s in self.slots:
            for e in read_jsonl(s.event_log_path):
                if e.get("event") != "op_visible":
                    continue
                for t, n in (e.get("tenants") or {}).items():
                    observed[t] = observed.get(t, 0) + int(n)
        coverage: Dict[str, float] = {}
        for t in (*self.MT_TENANTS, self.MT_NOISY):
            ops = len(self.mt_expected[t])
            assert ops > 0, (
                f"tenant {t!r} admitted no ops; MT schedule dead?")
            expected = ops * (len(self.slots) - 1)
            cov = observed.get(t, 0) / expected
            assert cov >= min_coverage, (
                f"tenant {t!r} propagation coverage {cov:.3f} < "
                f"{min_coverage}: observed {observed.get(t, 0)} of "
                f"{expected} expected visibilities")
            assert cov <= 1.0 + 1e-9, (
                f"tenant {t!r} propagation coverage {cov:.3f} > 1: the "
                "vv-delta exactly-once derivation double-counted")
            coverage[t] = cov
        self.report.mt_prop_coverage = coverage

    def _check_slo_accounting(self) -> None:
        """slo_breach <-> ingest_shed 1:1: the noisy tenant's forced
        quota sheds must surface as a ``shed_ratio`` SLO breach whose
        ``n_sheds`` equals the count of that tenant's ``ingest_shed``
        provenance events — same source, two sinks, so any drift is a
        lost record.  The registry counters behind the breach live in
        ONE incarnation (a crash takes them down, a reboot starts fresh
        ones), so the event side is sliced the same way: per slot, only
        records after the LAST ``boot`` marker in its log — the exact
        window the live scrape can see."""
        from crdt_tpu_torch.obs import fleet as fleet_lib

        rollup = self._fleet_report
        assert rollup is not None, "fleet rollup unavailable (no live member)"
        breaches = rollup.get("slo_breaches", [])
        cur_records: List[Dict[str, Any]] = []
        for s in self.slots:
            recs = read_jsonl(s.event_log_path)
            last_boot = max((i for i, e in enumerate(recs)
                             if e.get("event") == "boot"), default=-1)
            cur_records.extend(recs[last_boot + 1:])
        cur_noisy = sum(
            1 for e in cur_records if e.get("event") == "ingest_shed"
            and e.get("tenant") == self.MT_NOISY)
        noisy = [b for b in breaches
                 if b.get("tenant") == self.MT_NOISY
                 and b.get("kind") == "shed_ratio"]
        if cur_noisy > 0:
            # (the noisy tenant ALWAYS sheds somewhere across the run —
            # _check_multitenant_oracle already held every shed against
            # the client-observed 429s over the full log; this gate is
            # about the live scrape matching its own window)
            assert noisy, (
                f"noisy tenant {self.MT_NOISY!r} shed {cur_noisy}x in the "
                f"current incarnations but no shed_ratio slo_breach was "
                f"recorded (breaches: {breaches})")
        rec = fleet_lib.reconcile_sheds(breaches, cur_records)
        for tenant, row in rec["tenants"].items():
            assert row["ok"], (
                f"slo_breach shed accounting for {tenant!r} does not "
                f"reconcile with ingest_shed provenance: {rec}")
        if noisy:
            # the crossing is ALSO a first-class event in the black box
            assert any(e.get("event") == "slo_breach"
                       for e in cur_records), (
                "slo_breach evaluated but never landed in a node's log")
        self.report.slo_breaches = len(breaches)

    def _check_assembly(self, min_coverage: float = 0.95) -> None:
        """The flight-recorder gate: assemble the fleet's JSONL logs into
        one Perfetto timeline and require the blame report to explain
        >= min_coverage of the convergence-lag spikes from the applied
        fault log (op-level propagation tracing must be actionable)."""
        records = assemble.load_node_logs(
            [s.event_log_path for s in self.slots])
        assert records, "no node events were logged; recorder dead?"
        trace = assemble.assemble_trace(records, fault_records=self.plane.log)
        events = trace.get("traceEvents", [])
        assert events, "assembled Perfetto trace is empty"
        assert any(e.get("ph") == "X" for e in events), (
            "assembled trace has no gossip-round spans"
        )
        blame = assemble.blame_report(records, self.plane.log)
        self.report.blame_coverage = blame["coverage"]
        assert blame["coverage"] >= min_coverage, (
            f"blame report explains only {blame['coverage']:.3f} of "
            f"{blame['n_spikes']} lag spikes (< {min_coverage}); "
            f"unexplained: "
            f"{[s for s in blame['spikes'] if s['cause'] == 'unexplained'][:3]}"
        )

    def close(self) -> None:
        for s in self.slots:
            if s.alive:
                s.crash()
        self.plane.close()
        self._tmp.cleanup()

    def write_postmortem(self) -> Optional[str]:
        """Bundle every node's JSONL black box + the applied-fault log +
        the assembled trace + blame report into postmortem-<seed>.tar.gz
        on failure.  Must run BEFORE close():
        the event logs live in the soak's temp dir."""
        if self.postmortem_dir is None:
            return None
        out = str(pathlib.Path(self.postmortem_dir)
                  / f"postmortem-{self.seed}.tar.gz")
        rollup = self._fleet_report
        if rollup is None:
            # best-effort: a failure before heal_and_check still gets
            # the point-in-time fleet view of whoever is alive
            try:
                rollup = self._fleet_rollup()
            except Exception:
                rollup = None
        try:
            assemble.write_postmortem(
                out, [s.event_log_path for s in self.slots],
                fault_records=self.plane.log,
                extra={"fleet.json": rollup} if rollup is not None
                else None,
            )
        except OSError as e:
            print(f"[nemesis] postmortem bundling failed: {e}")
            return None
        print(f"[nemesis] postmortem bundle: {out}")
        return out

    def run(self) -> NemesisReport:
        try:
            for i in range(self.steps):
                self.step(i)
            return self.heal_and_check()
        except AssertionError:
            self.write_postmortem()
            raise
        finally:
            self.close()


def run_soak(seed: int, nodes: int, steps: int,
             fault_log: Optional[str] = None,
             postmortem_dir: Optional[str] = None,
             assemble_check: bool = False,
             composite: bool = False,
             overload: bool = False,
             gc: bool = False,
             strong: bool = False,
             crash_coordinator: bool = False,
             multitenant: bool = False,
             reshard: bool = False,
             ks_mesh: str = "auto",
             audit: bool = False,
             device=None) -> NemesisReport:
    rep = NemesisSoak(seed, nodes=nodes, steps=steps, device=device,
                      fault_log=fault_log, postmortem_dir=postmortem_dir,
                      assemble_check=assemble_check,
                      composite=composite, overload=overload,
                      gc=gc, strong=strong,
                      crash_coordinator=crash_coordinator,
                      multitenant=multitenant, reshard=reshard,
                      ks_mesh=ks_mesh, audit=audit).run()
    if gc:
        # shadow arm: the IDENTICAL soak with GC never driven.  The GC
        # drive sits outside the action rng and the fault coins are pure
        # functions of (seed, step, edge, rule), so both arms replay the
        # same writes and the same fault decisions — coordinated GC must
        # change NOTHING about the converged lattice, only the footprint.
        shadow = NemesisSoak(seed, nodes=nodes, steps=steps, device=device,
                             postmortem_dir=postmortem_dir,
                             composite=composite, overload=overload,
                             gc=False, strong=strong,
                             crash_coordinator=crash_coordinator).run()
        assert rep.writes_ledger == shadow.writes_ledger, (
            f"seed {seed}: GC arm minted {rep.writes_ledger} but the "
            f"shadow minted {shadow.writes_ledger} — the GC drive leaked "
            "into the action rng stream"
        )
        assert rep.final_vv == shadow.final_vv, (
            f"seed {seed}: converged vv differs with GC on "
            f"({rep.final_vv}) vs off ({shadow.final_vv})"
        )
        assert rep.state_json == shadow.state_json, (
            f"seed {seed}: converged state is NOT bit-equal with GC on "
            f"vs off ({len(rep.state_json)} vs {len(shadow.state_json)} "
            "bytes) — compaction changed the lattice"
        )
        assert rep.gc_mints > 0, (
            f"seed {seed}: gc soak never minted a frontier; oracle "
            "exercised nothing"
        )
        assert rep.gc_retained < shadow.gc_retained, (
            f"seed {seed}: GC arm retained {rep.gc_retained} raw commands "
            f"vs {shadow.gc_retained} without GC — no footprint win"
        )
        rep.gc_retained_shadow = shadow.gc_retained
    if audit:
        # plant-free arm: the IDENTICAL soak with the flip rules never
        # planted.  The audit drive consults the same decide() coins in
        # both arms and everything else it does sits outside the action
        # rng, so the wire-call census must match EXACTLY — that equality
        # IS the "digest plane adds zero new round trips" claim, pinned —
        # and a single drift/divergence event here is a false positive.
        clean = NemesisSoak(seed, nodes=nodes, steps=steps, device=device,
                            postmortem_dir=postmortem_dir,
                            audit=True, audit_plant=False).run()
        assert clean.audit_planted == 0 and clean.audit_drifts == 0 \
            and clean.audit_divergences == 0, (
                f"seed {seed}: plant-free audit arm raised "
                f"{clean.audit_drifts} drift(s) / "
                f"{clean.audit_divergences} divergence(s): false positive"
            )
        assert rep.wire_census == clean.wire_census, (
            f"seed {seed}: wire-call census diverged between the planted "
            f"and plant-free audit arms ({rep.wire_census} vs "
            f"{clean.wire_census}) — the audit plane added round trips"
        )
        assert rep.state_json == clean.state_json, (
            f"seed {seed}: planted winner-ts flips changed the converged "
            "STATE — the plant is supposed to be value-invisible"
        )
    return rep


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.harness.nemesis_soak",
        description="nemesis fault-injection soak")
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seeds", type=int, default=1,
                    help="run seeds 0..N-1")
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--fault-log", default=None,
                    help="write the applied-fault JSONL here")
    ap.add_argument("--replay-check", action="store_true",
                    help="run each seed twice and require byte-identical "
                         "fault logs (the determinism contract)")
    ap.add_argument("--assemble-check", action="store_true",
                    help="assemble the fleet's flight-recorder logs and "
                         "require the blame report to explain >= 95%% of "
                         "convergence-lag spikes")
    ap.add_argument("--postmortem-dir", default=".",
                    help="where postmortem-<seed>.tar.gz lands on failure")
    ap.add_argument("--composite", action="store_true",
                    help="also serve + fault + converge the algebra-"
                         "derived mapof(pncounter) composite node")
    ap.add_argument("--overload", action="store_true",
                    help="drive admission bursts against a tiny ingest "
                         "high-water mark and require every shed to be "
                         "black-boxed 1:1 (client 429s == ingest_shed "
                         "events, down to the op totals)")
    ap.add_argument("--gc", action="store_true",
                    help="drive stability-frontier GC on a fixed cadence "
                         "and replay a GC-off shadow arm: converged state "
                         "must be bit-equal, no op above a minted "
                         "frontier may ever be collected (ledger audit), "
                         "and the retained op log must shrink")
    ap.add_argument("--strong", action="store_true",
                    help="mix linearizable reads + CAS into the schedule: "
                         "strong ops must 503 (never serve stale) during "
                         "quorum loss, match consistency_unavailable "
                         "events 1:1, and recover outright after heal")
    ap.add_argument("--crash-coordinator", action="store_true",
                    help="(implies --strong) crash the acting leaseholder "
                         "mid-CAS (post-mint, pre-push-quorum) and stage "
                         "zombie handoffs: <=1 committed decision per "
                         "(lease slot, fence epoch), every stale-stamped "
                         "push refused loudly, full recovery after heal")
    ap.add_argument("--multitenant", action="store_true",
                    help="drive a simulated million-key, multi-tenant "
                         "workload through the sharded keyspace tier: "
                         "per-tenant views must converge bit-exact to the "
                         "admission ledger on every node, only the noisy "
                         "tenant may shed/quarantine (tenant-labeled "
                         "events 1:1 vs client counts), and post-heal "
                         "shard-local GC must empty every shard op log")
    ap.add_argument("--reshard", action="store_true",
                    help="(implies --multitenant) run the online "
                         "keyspace resharding (2 -> 4 shards) inside "
                         "the fault schedule: migration slices cross "
                         "corrupt/drop windows, a durable crash lands "
                         "mid-window and must resume from the reshard "
                         "ledger, the staggered cutover's stale pulls "
                         "must 409 off the epoch fence (1:1 events), "
                         "and the converged fleet must hold one epoch, "
                         "disjoint ownership, and ledger-exact tenant "
                         "views")
    ap.add_argument("--audit", action="store_true",
                    help="drive the live divergence audit plane: frontier-"
                         "anchored state digests compared on every gossip "
                         "round, silent planted winner-ts flips (fault op "
                         "'state') convicted 1:1 by the watchdog's scrub "
                         "and peer divergence_detected events with an "
                         "auto-postmortem bundle, plus a plant-free arm "
                         "pinning zero false positives and a bit-equal "
                         "wire-call census (zero new round trips)")
    ap.add_argument("--ks-mesh", choices=("auto", "on", "off"),
                    default="auto",
                    help="keyspace_mesh knob for --multitenant: route "
                         "shard convergence through the mesh plane's fused "
                         "step (parallel.meshplane); 'on' forces fusion "
                         "even on one device")
    ap.add_argument("--race-check", action="store_true",
                    help="run under the witnessed-race detector "
                         "(analysis.verify.race) and fail on any "
                         "unsynchronized shared-state access pair")
    ap.add_argument("--device", default=None,
                    help="the fleet's torch device (default: the CUDA "
                         "card; the command exits 2 without one rather "
                         "than fall back; cpu is for the tests)")
    args = ap.parse_args(argv)
    try:
        device = default_device(args.device)
    except RuntimeError as e:
        print(f"nemesis_soak: {e}", file=sys.stderr)
        return 2
    race = None
    if args.race_check:
        # install BEFORE any NodeHost is built: locks created before the
        # install are invisible to the vector clocks and would surface as
        # false witnesses
        from crdt_tpu_torch.analysis.verify import race
        race.install()
    try:
        return _run_seeds(args, device, race)
    finally:
        if race is not None:
            race.uninstall()


def _race_check(seed: int, race) -> None:
    """Fail the seed on any witness, or on a run that touched no watched
    attribute (a check that observed nothing proves nothing)."""
    rpt = race.report()
    reads = sum(c["reads"] for c in rpt["access_counts"].values())
    writes = sum(c["writes"] for c in rpt["access_counts"].values())
    assert reads + writes > 0, (
        "race detector observed zero watched accesses: "
        "instrumentation dead or watch list empty")
    if rpt["witness_count"]:
        for w in rpt["witnesses"]:
            print(w)
        raise AssertionError(
            f"seed {seed}: {rpt['witness_count']} witnessed race(s) on shared "
            f"runtime state (above)")
    print(f"[nemesis] race-check OK: 0 witnesses over {reads} reads / "
          f"{writes} writes across {len(rpt['access_counts'])} watchpoints")
    race.reset()


def _run_seeds(args, device, race) -> int:
    modes = dict(composite=args.composite, overload=args.overload,
                 gc=args.gc, strong=args.strong or args.crash_coordinator,
                 crash_coordinator=args.crash_coordinator,
                 multitenant=args.multitenant, reshard=args.reshard,
                 ks_mesh=args.ks_mesh, audit=args.audit, device=device)
    for k in range(args.seeds):
        seed = args.seed_base + k
        if args.replay_check:
            with tempfile.TemporaryDirectory(prefix="nemesis_replay_") as d:
                log_a = str(pathlib.Path(d) / "a.jsonl")
                log_b = str(pathlib.Path(d) / "b.jsonl")
                rep = run_soak(seed, args.nodes, args.steps, fault_log=log_a,
                               postmortem_dir=args.postmortem_dir,
                               assemble_check=args.assemble_check, **modes)
                run_soak(seed, args.nodes, args.steps, fault_log=log_b,
                         postmortem_dir=args.postmortem_dir, **modes)
                a = pathlib.Path(log_a).read_bytes()
                b = pathlib.Path(log_b).read_bytes()
                assert a == b, (
                    f"seed {seed}: two runs diverged — fault logs differ "
                    f"({len(a)} vs {len(b)} bytes); determinism broken"
                )
                print(f"[nemesis] replay-check OK: {rep.summary()}")
        else:
            rep = run_soak(seed, args.nodes, args.steps,
                           fault_log=args.fault_log,
                           postmortem_dir=args.postmortem_dir,
                           assemble_check=args.assemble_check, **modes)
            print(f"[nemesis] {rep.summary()}")
        if race is not None:
            _race_check(seed, race)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
