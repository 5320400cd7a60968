"""Jepsen-lite soak harness: a seeded adversarial schedule against the
in-process cluster (``SoakRunner``) or against served network daemons
(``NetworkSoakRunner``), with oracle-checked invariants (own copy of
``crdt_tpu.harness.soak``).

A seeded random schedule interleaves writes, gossip pulls, kill/revive
(the /condition capability) and compaction barriers, then heals the
cluster and checks:

  I1  durability   — every ACCEPTED write survives to the healed fixpoint
                     (state == the oracle fold of exactly the accepted
                     commands; nothing lost, nothing invented);
  I2  availability — a dead node rejects writes (the reference 502s);
  I3  liveness     — the healed cluster converges within a bounded number
                     of rounds;
  I4  safety       — no step ever raises.

Every replica shares one ``BirthLedger`` and the report's step clock, so
the registry holds propagation-steps histograms
(``obs.provenance.propagation_summary`` folds them).

    python -m crdt_tpu_torch.harness.soak --steps 2000 --seeds 3
    python -m crdt_tpu_torch.harness.soak --network --paged 0.25 --steps 400 --seeds 1

``--device`` picks the torch device (default: the CUDA card; without one
the command exits 2 rather than fall back).
"""
from __future__ import annotations

import dataclasses
import json
import random
import sys
from typing import Dict, Optional

from crdt_tpu_torch.api.cluster import LocalCluster
from crdt_tpu_torch.obs.provenance import BirthLedger, propagation_summary
from crdt_tpu_torch.oracle.replica import OracleReplica
from crdt_tpu_torch.utils.config import ClusterConfig


@dataclasses.dataclass
class SoakReport:
    steps: int
    writes_offered: int
    writes_accepted: int
    writes_rejected_dead: int
    gossip_rounds: int
    kills: int
    revivals: int
    barriers: int
    barriers_skipped: int
    rounds_to_converge: int
    final_state: Dict[str, str]
    pages_admitted: int = 0
    # end-of-run registry snapshot (counters + latency summaries): machine-
    # readable companion to __str__, carried into the CLI's JSON line
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)

    @classmethod
    def zero(cls) -> "SoakReport":
        return cls(
            steps=0, writes_offered=0, writes_accepted=0,
            writes_rejected_dead=0, gossip_rounds=0, kills=0, revivals=0,
            barriers=0, barriers_skipped=0, rounds_to_converge=-1,
            final_state={},
        )

    def __str__(self) -> str:
        paged = (f", {self.pages_admitted} op pages"
                 if self.pages_admitted else "")
        return (
            f"soak: {self.steps} steps, {self.writes_accepted}/"
            f"{self.writes_offered} writes accepted "
            f"({self.writes_rejected_dead} rejected dead{paged}), "
            f"{self.gossip_rounds} pulls, {self.kills} kills / "
            f"{self.revivals} revivals, {self.barriers} barriers "
            f"(+{self.barriers_skipped} skipped), converged in "
            f"{self.rounds_to_converge} rounds, "
            f"{len(self.final_state)} keys"
        )


class SoakRunner:
    """One seeded adversarial schedule against a LocalCluster + oracles."""

    def __init__(
        self,
        config: Optional[ClusterConfig] = None,
        seed: int = 0,
        p_write: float = 0.45,
        p_gossip: float = 0.35,
        p_kill: float = 0.06,
        p_revive: float = 0.09,
        p_compact: float = 0.05,
        n_keys: int = 8,
        max_dead: Optional[int] = None,
        device=None,
    ):
        self.config = config or ClusterConfig(n_replicas=5, compact_every=0)
        self.rng = random.Random(seed)
        self.cluster = LocalCluster(self.config, device=device)
        # one quirk-free oracle per node, mirroring ACCEPTED commands only
        self.oracles = [
            OracleReplica(rid=n.rid) for n in self.cluster.nodes
        ]
        self.p = (p_write, p_gossip, p_kill, p_revive, p_compact)
        self.keys = [f"k{i}" for i in range(n_keys)]
        # by default keep at least ONE node alive (max_dead = n-1) — the
        # harshest schedule where reads still have a server; barriers are
        # mostly skipped out there, and liveness/durability must hold for
        # ANY schedule regardless
        self.max_dead = (
            max_dead if max_dead is not None
            else len(self.cluster.nodes) - 1
        )
        self.report = SoakReport.zero()
        # convergence flight recorder: one fleet-shared birth ledger and
        # the report's step counter as the deterministic time base ->
        # live propagation-steps histograms
        self.ledger = BirthLedger()
        for node in self.cluster.nodes:
            node.recorder.install(ledger=self.ledger,
                                  step_clock=lambda: self.report.steps)
            node.events.step_clock = lambda: self.report.steps

    # ---- schedule actions ----

    def _write(self) -> None:
        r = self.report
        idx = self.rng.randrange(len(self.cluster.nodes))
        node = self.cluster.nodes[idx]
        cmd = {
            self.rng.choice(self.keys): str(self.rng.randint(-20, 20)),
        }
        if self.rng.random() < 0.1:  # occasional non-numeric (LWW mode)
            cmd[self.rng.choice(self.keys)] = f"s{self.rng.randrange(100)}"
        if self.rng.random() < 0.15:  # occasional multi-key command
            cmd[self.rng.choice(self.keys)] = str(self.rng.randint(-5, 5))
        ts = self.cluster.nodes[0].clock.now_ms()
        r.writes_offered += 1
        accepted = node.add_command(cmd, ts=ts)
        if accepted:
            # mirror into the oracle with the SAME identity the node used
            self.oracles[idx].add_command(cmd, ts=ts)
            r.writes_accepted += 1
        else:
            assert not node.alive, "alive node must accept writes (I2)"
            r.writes_rejected_dead += 1

    def _gossip(self) -> None:
        idx = self.rng.randrange(len(self.cluster.nodes))
        if self.cluster.gossip_once(idx):
            self.report.gossip_rounds += 1

    def _kill(self) -> None:
        alive = [n for n in self.cluster.nodes if n.alive]
        if len(self.cluster.nodes) - len(alive) >= self.max_dead:
            return
        if not alive:
            return
        self.rng.choice(alive).set_alive(False)
        self.report.kills += 1

    def _revive(self) -> None:
        dead = [n for n in self.cluster.nodes if not n.alive]
        if not dead:
            return
        self.rng.choice(dead).set_alive(True)
        self.report.revivals += 1

    def _compact(self) -> None:
        if self.cluster.compact():
            self.report.barriers += 1
        else:
            self.report.barriers_skipped += 1

    def _tick(self) -> None:
        """A full cluster tick: one pull per replica AND the tick-scheduled
        compaction path (config.compact_every) — so scheduled barriers race
        the fault schedule, not just the explicit p_compact barriers."""
        before = self.cluster.metrics.snapshot()
        self.report.gossip_rounds += self.cluster.tick()
        after = self.cluster.metrics.snapshot()
        self.report.barriers += (
            after.get("compactions", 0) > before.get("compactions", 0)
        )
        self.report.barriers_skipped += (
            after.get("compact_skipped", 0) - before.get("compact_skipped", 0)
        ) > 0

    # ---- run ----

    def step(self) -> None:
        p_write, p_gossip, p_kill, p_revive, p_compact = self.p
        x = self.rng.random()
        if x < p_write:
            self._write()
        elif x < p_write + p_gossip:
            self._gossip()
        elif x < p_write + p_gossip + p_kill:
            self._kill()
        elif x < p_write + p_gossip + p_kill + p_revive:
            self._revive()
        elif x < p_write + p_gossip + p_kill + p_revive + p_compact:
            self._compact()
        else:
            self._tick()  # full round incl. the SCHEDULED compaction path
        self.report.steps += 1

    def heal_and_check(self, max_rounds: int = 400) -> SoakReport:
        """Heal every node, drive to the fixpoint, assert I1/I3."""
        r = self.report
        for n in self.cluster.nodes:
            n.set_alive(True)  # I3 setup: heal
        rounds = 0
        while not self.cluster.converged():
            assert rounds < max_rounds, "liveness violated (I3)"
            self.cluster.tick()
            rounds += 1
        r.rounds_to_converge = rounds
        want = OracleReplica.converged_state(self.oracles)
        got = self.cluster.nodes[0].get_state()
        assert got == want, (
            f"durability violated (I1): accepted-writes fold has "
            f"{len(want)} keys, cluster has {len(got)}; "
            f"diff={ {k: (want.get(k), got.get(k)) for k in set(want) | set(got) if want.get(k) != got.get(k)} }"
        )
        r.final_state = got
        r.metrics = self.cluster.metrics.snapshot()
        return r

    def run(self, n_steps: int) -> SoakReport:
        for _ in range(n_steps):
            self.step()  # I4: no step may raise
        return self.heal_and_check()


class NetworkSoakRunner:
    """The soak at the NETWORK level: N served NodeHosts (real sockets,
    delta gossip over the reference wire, coordinator-scheduled barriers)
    under the same seeded fault schedule and invariants as SoakRunner.

    Gossip is driven by hand (agent.gossip_once) for determinism; the
    fault model is /condition-style alive toggling, so a 'down' daemon
    refuses service while its server keeps listening, the reference's
    failure mode.  step() and heal_and_check() parallel SoakRunner's (other
    actions and convergence predicates, the same invariants).
    """

    def __init__(
        self,
        n: int = 3,
        seed: int = 0,
        p_write: float = 0.4,
        p_gossip: float = 0.35,
        p_kill: float = 0.06,
        p_revive: float = 0.09,
        p_compact: float = 0.1,
        n_keys: int = 6,
        config: Optional[ClusterConfig] = None,
        p_page: float = 0.0,
        device=None,
    ):
        from crdt_tpu_torch.api.net import NodeHost, RemotePeer

        self.rng = random.Random(seed)
        config = config or ClusterConfig()
        self.hosts = [
            NodeHost(rid=r, peers=[], config=config, device=device) for r in range(n)
        ]
        for h in self.hosts:
            h.agent.peers = [
                RemotePeer(o.url) for o in self.hosts if o is not h
            ]
            h.start_server()  # serve only: gossip is driven by step()
        self.clients = [RemotePeer(h.url) for h in self.hosts]
        self.oracles = [OracleReplica(rid=r) for r in range(n)]
        self.p = (p_write, p_gossip, p_kill, p_revive, p_compact)
        self.keys = [f"k{i}" for i in range(n_keys)]
        # paged writes: this fraction of write actions arrives as a small
        # columnar op page through the ingest front door instead of a
        # single-op POST, so the soak drives BOTH write surfaces under
        # kill/revive.  One builder per host is one writer stream.
        self.p_page = p_page
        if p_page:
            from crdt_tpu_torch.ingest import PageBuilder

            self.pagers = [PageBuilder(origin=r, page_size=1 << 20)
                           for r in range(n)]
        self.report = SoakReport.zero()
        # flight recorder: the shared ledger and report-step clock (as in
        # SoakRunner; the hosts are in process, so the ledger reaches all)
        self.ledger = BirthLedger()
        for h in self.hosts:
            h.install_flight_recorder(
                ledger=self.ledger, step_clock=lambda: self.report.steps)

    def close(self) -> None:
        for h in self.hosts:
            h.stop_server()

    def step(self) -> None:
        r = self.report
        p_write, p_gossip, p_kill, p_revive, p_compact = self.p
        x = self.rng.random()
        i = self.rng.randrange(len(self.hosts))
        if x < p_write and self.p_page and self.rng.random() < self.p_page:
            self._page_write(i)
        elif x < p_write:
            # numeric-only values: each daemon clock has its own epoch, so
            # cross-writer ts order in the oracle mirror means nothing;
            # sums are order-free, LWW strings would not be
            cmd = {self.rng.choice(self.keys): str(self.rng.randint(-20, 20))}
            r.writes_offered += 1
            # write OVER HTTP; mirror into the oracle with the node's
            # actual identity (ts assigned server-side, so read it back)
            if self.clients[i].add_command(cmd):
                r.writes_accepted += 1
                node = self.hosts[i].node
                # the latest own-write identity in O(1): the per-writer
                # index is seq-ascending
                ident = node._by_writer[node.rid][-1][0]
                self.oracles[i].add_command(cmd, ts=ident[0])
            else:
                assert not self.hosts[i].node.alive, "alive daemon refused"
                r.writes_rejected_dead += 1
        elif x < p_write + p_gossip:
            r.gossip_rounds += bool(self.hosts[i].agent.gossip_once())
        elif x < p_write + p_gossip + p_kill:
            alive = [h for h in self.hosts if h.node.alive]
            if len(alive) > 1:
                self.rng.choice(alive).node.set_alive(False)
                r.kills += 1
        elif x < p_write + p_gossip + p_kill + p_revive:
            dead = [h for h in self.hosts if not h.node.alive]
            if dead:
                self.rng.choice(dead).node.set_alive(True)
                r.revivals += 1
        elif x < p_write + p_gossip + p_kill + p_revive + p_compact:
            # a coordinator barrier from host 0 (skipped while any member
            # is down: network_compact cannot prove stability without it)
            if self.hosts[0].agent.compact_once():
                r.barriers += 1
            else:
                r.barriers_skipped += 1
        else:
            pass  # idle step
        r.steps += 1

    def _page_write(self, i: int) -> None:
        """A burst of numeric writes as ONE columnar op page through host
        i's ingest front door.  All-or-nothing: an admitted page mirrors
        every op into the oracle with the node's minted identities (read
        back from the seq-ascending per-writer index); a refused page (a
        dead node) mirrors nothing."""
        r = self.report
        n = self.rng.randint(2, 6)
        pager = self.pagers[i]
        for _ in range(n):
            pager.add(self.rng.choice(self.keys),
                      str(self.rng.randint(-20, 20)))
        raw = pager.flush()
        r.writes_offered += n
        res = self.hosts[i].ingest.admit_page(raw)
        if res["admitted"]:
            assert res["admitted"] == n, res
            r.writes_accepted += n
            r.pages_admitted += 1
            node = self.hosts[i].node
            for ident, cmd in node._by_writer[node.rid][-n:]:
                self.oracles[i].add_command(cmd, ts=ident[0])
        else:
            assert not self.hosts[i].node.alive, "alive daemon refused page"
            r.writes_rejected_dead += n

    def heal_and_check(self, max_rounds: int = 200) -> SoakReport:
        r = self.report
        for h in self.hosts:
            h.node.set_alive(True)
        rounds = 0
        while True:
            states = [h.node.get_state() for h in self.hosts]
            if all(s == states[0] for s in states[1:]):
                break
            assert rounds < max_rounds, "liveness violated (I3)"
            for h in self.hosts:
                h.agent.gossip_once()
            rounds += 1
        r.rounds_to_converge = rounds
        want = OracleReplica.converged_state(self.oracles)
        got = self.hosts[0].node.get_state()
        assert got == want, f"durability violated (I1): {got} != {want}"
        r.final_state = got
        r.metrics = self.hosts[0].agent.metrics.snapshot()
        return r

    def run(self, n_steps: int) -> SoakReport:
        try:
            for _ in range(n_steps):
                self.step()
            return self.heal_and_check()
        finally:
            self.close()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="randomized CRDT soak")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=5)
    ap.add_argument("--compact-every", type=int, default=0,
                    help="ALSO run scheduled barriers every N ticks")
    ap.add_argument("--full-gossip", action="store_true",
                    help="ship full logs every round instead of deltas")
    ap.add_argument("--fuse-k", type=int, default=1,
                    help="k-way fused pull rounds (ClusterConfig.fuse_pull_k):"
                         " each round merges k peers' payloads in ONE device"
                         " merge; 1 = reference single-peer rounds")
    ap.add_argument("--network", action="store_true",
                    help="run the soak over real sockets (NetworkSoakRunner)")
    ap.add_argument("--paged", type=float, default=0.0, metavar="P",
                    help="network mode: route this fraction of write "
                         "actions as columnar op pages through the ingest "
                         "front door (0 disables)")
    ap.add_argument("--device", default=None,
                    help="torch device of every replica's state (default: the "
                         "CUDA card; the command exits 2 without one rather "
                         "than fall back; cpu is for the tests)")
    args = ap.parse_args(argv)
    from crdt_tpu_torch import default_device

    try:
        device = default_device(args.device)
    except RuntimeError as e:
        print(f"python -m crdt_tpu_torch.harness.soak: {e}", file=sys.stderr)
        return 2
    if args.paged and not args.network:
        print("note: --paged applies only in --network mode (the in-memory "
              "cluster nodes have no front doors); ignoring",
              file=sys.stderr)
    if args.network and args.compact_every:
        print("note: --compact-every is schedule-driven in --network mode "
              "(the agents' timer loops are not running); barriers come "
              "from the p_compact action", file=sys.stderr)
    for seed in range(args.seeds):
        if args.network:
            runner = NetworkSoakRunner(
                n=args.replicas, seed=seed,
                config=ClusterConfig(delta_gossip=not args.full_gossip,
                                     fuse_pull_k=args.fuse_k),
                p_page=args.paged, device=device,
            )
            report = runner.run(args.steps)
        else:
            runner = SoakRunner(
                ClusterConfig(
                    n_replicas=args.replicas,
                    compact_every=args.compact_every,
                    delta_gossip=not args.full_gossip,
                    fuse_pull_k=args.fuse_k,
                ),
                seed=seed, device=device,
            )
            report = runner.run(args.steps)
        print(f"seed {seed}: {report}")
        # the machine-readable companion line
        print(json.dumps({
            "seed": seed, "steps": report.steps,
            "metrics": {k: round(v, 4) for k, v in report.metrics.items()},
        }, sort_keys=True))
        # the flight recorder's rollup: measured op propagation lag across
        # every origin -> observer edge
        if args.network:
            prop = propagation_summary(
                *(h.node.metrics.registry for h in runner.hosts))
        else:
            prop = propagation_summary(
                runner.cluster.nodes[0].metrics.registry)
        if prop:
            print(json.dumps({"seed": seed, "propagation": prop},
                             sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
