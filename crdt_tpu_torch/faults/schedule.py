"""Replayable nemesis schedules — the deterministic half of the fault
plane (own copy of ``crdt_tpu.faults.schedule``; the same seed gives the
same rules, decisions and fault-log bytes in both packages).

A :class:`NemesisSchedule` is a pure value: a seed, a step horizon, and a
list of :class:`FaultRule` windows + :class:`SkewEvent` markers.  The same
(seed, nodes, steps) triple ALWAYS generates the same schedule, and the
same schedule driven through a :class:`FaultPlane` always makes the same
per-message decisions — every probabilistic coin is keyed by
``(seed, step, src, dst, op, rule_index)`` through its own string-seeded
``random.Random``, never by global RNG state or wall time.  That is what
lets ``harness/nemesis_soak.py`` replay a failing run from nothing but
its seed, and what the CI determinism check pins (two same-seed runs must
produce byte-identical fault logs).

Jepsen's nemesis is the model ("Linearizable State Machine Replication of
State-Based CRDTs without Logs", PAPERS.md, is the law being hammered):
the schedule composes asymmetric partitions, per-edge message faults
(drop / delay / duplicate / reorder / truncate / corrupt), slow peers,
disk faults, and clock skew; ``FaultPlane.heal`` ends the hostile phase
so convergence-after-heal can be asserted.
"""
from __future__ import annotations

import dataclasses
import json
import random
import threading
from typing import Any, Dict, List, Optional, Tuple

# message-fault kinds a FaultRule may carry (op="disk" rules reuse
# "delay" for fsync stalls and "truncate"/"corrupt" for torn writes)
KINDS = ("drop", "delay", "duplicate", "reorder", "truncate", "corrupt")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One fault window: inject ``kind`` on messages matching
    (src, dst, op) during steps [start, end), each with probability ``p``.
    ``src``/``dst`` are node labels (the soak uses slot numbers as
    strings), ``op`` the wire surface ("gossip", "set_gossip", "data",
    "vv", "disk", ...); "*" matches anything.  ``arg`` parameterizes the
    kind (delay/stall seconds)."""

    kind: str
    src: str = "*"
    dst: str = "*"
    op: str = "*"
    start: int = 0
    end: int = 1 << 30
    p: float = 1.0
    arg: float = 0.0

    def matches(self, step: int, src: str, dst: str, op: str) -> bool:
        return (
            self.start <= step < self.end
            and self.src in ("*", src)
            and self.dst in ("*", dst)
            and self.op in ("*", op)
        )


def reshard_window_rules(start: int, end: int) -> List["FaultRule"]:
    """Fault windows aimed at the reshard migration stream (op
    "ks_migrate", the POST /ks/migrate leg): a CORRUPT window in the
    first half — mangled wire key, receiver must quarantine the slice
    whole — and a DROP window (partitioned migration stream; resume
    re-streams idempotently) in the second.  The sub-windows are
    DISJOINT so every recorded corrupt reconciles 1:1 with a receiver
    ks_reshard_quarantine event — a drop co-firing on the same decision
    would swallow the corrupted message before it arrived."""
    mid = max(start + 1, (start + end) // 2)
    return [
        FaultRule("corrupt", op="ks_migrate", start=start, end=mid,
                  p=0.6),
        FaultRule("drop", op="ks_migrate", start=mid, end=end, p=0.5),
    ]


def divergence_rules(start: int, end: int, node: str = "*",
                     p: float = 1.0) -> List["FaultRule"]:
    """The planted silent-corruption fault (crdt_tpu_torch.obs.audit): a
    ``flip`` rule on the ``op="state"`` pseudo-edge.  Not a message
    fault — the soak driver asks ``decide(node, node, "state")`` once
    per (node, round) and, when the flip fires, calls
    ``plant_divergence`` on that node post-merge: one committed row's
    winner timestamp silently changes without the incremental digest
    hearing about it.  Appended explicitly like ``reshard_window_rules``
    (never ``generate()``d): a planted divergence is opted into by the
    audit soak alone, whose oracle then holds ``divergence_detected``
    provenance against exactly these decisions, 1:1."""
    return [FaultRule("flip", src=node, dst=node, op="state",
                      start=start, end=end, p=p)]


@dataclasses.dataclass(frozen=True)
class SkewEvent:
    """At ``step``, shift node ``node``'s clock epoch by ``skew_ms`` —
    CRDT convergence must not depend on synchronized clocks (the lattice
    orders by (ts, rid, seq); skew only biases last-writer-wins picks,
    never breaks join semantics)."""

    step: int
    node: str
    skew_ms: int


@dataclasses.dataclass(frozen=True)
class NemesisSchedule:
    seed: int
    steps: int
    nodes: int
    rules: Tuple[FaultRule, ...]
    skews: Tuple[SkewEvent, ...]

    @classmethod
    def generate(cls, seed: int, nodes: int, steps: int,
                 partitions: bool = True, message_faults: bool = True,
                 disk_faults: bool = True,
                 clock_skew: bool = True) -> "NemesisSchedule":
        """Deterministically derive a composed fault schedule from the
        seed: partition windows (directional drop rules across a random
        cut, asymmetric half the time), per-kind message-fault windows,
        one slow peer, disk-fault windows (fsync stall + torn write), and
        clock-skew events.  All windows end by ~80% of the horizon so the
        driver's explicit ``heal()`` + pull rounds always have a clean
        tail to converge in."""
        rng = random.Random(f"nemesis-schedule:{seed}:{nodes}:{steps}")
        labels = [str(i) for i in range(nodes)]
        horizon = max(1, int(steps * 0.8))
        rules: List[FaultRule] = []
        skews: List[SkewEvent] = []

        def window(max_len: int) -> Tuple[int, int]:
            length = rng.randint(max(2, max_len // 2), max(3, max_len))
            start = rng.randint(0, max(0, horizon - length))
            return start, start + length

        if partitions and nodes >= 2:
            for _ in range(max(1, steps // 40)):
                start, end = window(max(4, steps // 5))
                side = set(rng.sample(labels, rng.randint(1, nodes - 1)))
                asymmetric = rng.random() < 0.5
                for a in labels:
                    for b in labels:
                        if a == b or (a in side) == (b in side):
                            continue
                        # asymmetric cut: only traffic INTO the minority
                        # side is dropped — the far side still hears us
                        if asymmetric and b not in side:
                            continue
                        rules.append(FaultRule(
                            "drop", src=a, dst=b, start=start, end=end,
                        ))
        if message_faults:
            for kind in ("drop", "delay", "duplicate", "reorder",
                         "truncate", "corrupt"):
                for _ in range(rng.randint(1, 2)):
                    start, end = window(max(3, steps // 6))
                    rules.append(FaultRule(
                        kind,
                        src=rng.choice(labels + ["*"]),
                        dst=rng.choice(labels + ["*"]),
                        start=start, end=end,
                        p=round(rng.uniform(0.3, 0.9), 3),
                        arg=round(rng.uniform(0.005, 0.02), 4)
                        if kind == "delay" else 0.0,
                    ))
            # one standing slow peer: every message toward it crawls
            start, end = window(max(3, steps // 4))
            rules.append(FaultRule(
                "delay", dst=rng.choice(labels), start=start, end=end,
                p=1.0, arg=round(rng.uniform(0.005, 0.015), 4),
            ))
        if disk_faults:
            start, end = window(max(3, steps // 5))
            rules.append(FaultRule(
                "delay", op="disk", start=start, end=end,
                p=round(rng.uniform(0.3, 0.7), 3),
                arg=round(rng.uniform(0.01, 0.05), 4),
            ))
            start, end = window(max(3, steps // 6))
            rules.append(FaultRule(
                "truncate", op="disk", start=start, end=end,
                p=round(rng.uniform(0.2, 0.5), 3),
            ))
        if clock_skew:
            for _ in range(rng.randint(1, max(1, nodes))):
                skews.append(SkewEvent(
                    step=rng.randint(0, horizon),
                    node=rng.choice(labels),
                    skew_ms=rng.randint(-1500, 1500),
                ))
        return cls(seed=seed, steps=steps, nodes=nodes,
                   rules=tuple(rules), skews=tuple(skews))

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed, "steps": self.steps, "nodes": self.nodes,
            "rules": [dataclasses.asdict(r) for r in self.rules],
            "skews": [dataclasses.asdict(s) for s in self.skews],
        }, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "NemesisSchedule":
        d = json.loads(text)
        return cls(
            seed=int(d["seed"]), steps=int(d["steps"]),
            nodes=int(d["nodes"]),
            rules=tuple(FaultRule(**r) for r in d.get("rules", [])),
            skews=tuple(SkewEvent(**s) for s in d.get("skews", [])),
        )


class FaultPlane:
    """The live decision engine for one run of a schedule.

    The driver advances ``plane.step`` once per soak step; every shimmed
    I/O call asks :meth:`decide` which faults apply to its (src, dst, op)
    edge right now.  Decisions are PURE (no state mutated, no log
    written): the shims record only faults they actually APPLY, via
    :meth:`record`, so the fault log is the ground truth of what the run
    experienced — and carries step indices, never wall timestamps, so two
    same-seed runs produce byte-identical logs.

    ``heal()`` makes every rule inert from that point on (the jepsen
    "nemesis off" phase); quarantined state and open circuit breakers
    then drain through ordinary anti-entropy.
    """

    def __init__(self, schedule: NemesisSchedule,
                 log_path: Optional[str] = None):
        self.schedule = schedule
        self.step = 0
        self.healed = False
        # the log is appended from gossip worker threads (fused pulls run
        # shims concurrently) and read by the driver — lock every access
        self._lock = threading.Lock()
        self.log: List[Dict[str, Any]] = []
        # decide() calls so far, by op.  Every shimmed wire call asks
        # exactly once (pre-heal and post-heal alike), so this histogram
        # IS the run's wire-call census — the audit soak pins its
        # zero-new-round-trips claim on the census matching a digest-free
        # arm of the same seed exactly.
        self.decisions: Dict[str, int] = {}
        self._file = open(log_path, "a") if log_path else None

    def decide(self, src: str, dst: str, op: str) -> Dict[str, FaultRule]:
        """Which faults hit a (src, dst, op) message at the current step:
        {kind: rule} for every kind whose FIRST matching rule wins its
        probability coin.  The coin is keyed by the full decision identity
        — same seed, same step, same edge, same rule index → same flip,
        on any host, in any process.  Decisions stay pure (nothing in the
        fault log); only the per-op call census is counted."""
        with self._lock:
            self.decisions[op] = self.decisions.get(op, 0) + 1
        if self.healed:
            return {}
        step = self.step
        out: Dict[str, FaultRule] = {}
        for i, r in enumerate(self.schedule.rules):
            if r.kind in out or not r.matches(step, src, dst, op):
                continue
            coin = random.Random(
                f"{self.schedule.seed}:{step}:{src}:{dst}:{op}:{i}"
            ).random()
            if coin < r.p:
                out[r.kind] = r
        return out

    def skews_at(self, step: int) -> List[SkewEvent]:
        if self.healed:
            return []
        return [s for s in self.schedule.skews if s.step == step]

    def record(self, fault: str, **fields: Any) -> None:
        """Append one APPLIED-fault record (step-indexed, no wall time)."""
        rec = {"step": self.step, "fault": fault}
        rec.update(fields)
        with self._lock:
            self.log.append(rec)
            if self._file is not None:
                self._file.write(json.dumps(rec, sort_keys=True) + "\n")
                self._file.flush()

    def heal(self) -> None:
        """End the hostile phase: every subsequent decide() returns no
        faults and pending skews stop applying.  Recorded in the log so
        replay diffs cover the heal point too."""
        self.record("heal")
        self.healed = True

    def counts(self) -> Dict[str, int]:
        """Applied-fault histogram (the soak report's summary line)."""
        with self._lock:
            out: Dict[str, int] = {}
            for rec in self.log:
                out[rec["fault"]] = out.get(rec["fault"], 0) + 1
            return out

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
