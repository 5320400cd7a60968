"""The port's crdtprove and witnessed-race detector
(crdt_tpu_torch.analysis) against the JAX package's, the twins of
tests/test_verify.py's prover, ledger, CLI and race cases: the planted
defective joins refuted with concrete counterexamples, real joins proved
with the laws and spaces of JAX's live ``prove_spec``, the port's
committed ledger equal to JAX's committed one join for join (verdicts and
domains), the fingerprint cache, the CLI's exit codes, and the race
detector's four cases and watchpoints.  Everything on the CPU."""
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.analysis.verify import ledger as jledger, prove as jprove
from crdt_tpu.ops.joins import registered_joins as j_registered
from crdt_tpu_torch.analysis import __main__ as cli
from crdt_tpu_torch.analysis.verify import ledger, prove, race
from crdt_tpu_torch.analysis.verify.domains import build_domain, state_key
from crdt_tpu_torch.ops import joins as joins_mod
from crdt_tpu_torch.ops.joins import JoinSpec, registered_joins


def _spec(name, join, zero, small):
    return JoinSpec(name, join, lambda device=None: (zero(device), zero(device)),
                    neutral=lambda device=None: zero(device),
                    small=lambda device=None: small(device))


# ---- planted defective joins ----


def _avg_spec():
    """A weighted mean posing as a join: float AND asymmetric, refuted on
    commutativity (0.6a+0.4b != 0.6b+0.4a whenever a != b)."""
    return _spec("bad_avg", lambda a, b: 0.6 * a + 0.4 * b,
                 lambda d: torch.zeros(2, dtype=torch.float32, device=d),
                 lambda d: [torch.tensor([v, 0.0], dtype=torch.float32, device=d)
                            for v in (0.0, 1.0, 2.0)])


def _sat_spec():
    """A saturating int8 add: a+b wraps at 127 before the clamp at 100
    can catch it (80+80 -> -96), so idempotence and inflationarity
    break."""
    return _spec("bad_sat", lambda a, b: torch.minimum(a + b, torch.tensor(100, dtype=torch.int8)),
                 lambda d: torch.zeros(2, dtype=torch.int8, device=d),
                 lambda d: [torch.tensor([v, 0], dtype=torch.int8, device=d)
                            for v in (0, 3, 80)])


def test_prover_refutes_noncommutative_float_join():
    entry = prove.prove_spec(_avg_spec(), registry={}, device="cpu")
    assert entry["verdict"] == "refuted"
    assert "commutative" in entry["refuted_laws"]
    ce = entry["laws"]["commutative"]["counterexample"]
    assert set(ce) == {"a", "b", "lhs", "rhs"}
    assert ce["lhs"] != ce["rhs"]


def test_prover_refutes_saturating_overflow_join():
    entry = prove.prove_spec(_sat_spec(), registry={}, device="cpu")
    assert entry["verdict"] == "refuted"
    assert "idempotent" in entry["refuted_laws"]
    assert "inflationary" in entry["refuted_laws"]
    ce = entry["laws"]["idempotent"]["counterexample"]
    assert ce["lhs"] != ce["rhs"]
    assert ce == {"a": {".": "int8[2]:[3, 0]"}, "lhs": {".": "int8[2]:[6, 0]"},
                  "rhs": {".": "int8[2]:[3, 0]"}}


@pytest.mark.parametrize("name", ["gcounter", "lww"])
def test_real_joins_prove_like_jax(name):
    """The blaster end to end on two real lattices: proved, closed, and
    every law's verdict and space equal to JAX's live prove_spec."""
    registry = registered_joins()
    entry = prove.prove_spec(registry[name], registry, device="cpu")
    want = jprove.prove_spec(j_registered()[name])
    assert entry["verdict"] == want["verdict"] == "proved"
    assert entry["domain"] == want["domain"] and entry["domain"]["closed"]
    assert {k: (v["holds"], v["space"]) for k, v in entry["laws"].items()} == \
        {k: (v["holds"], v["space"]) for k, v in want["laws"].items()}
    assert entry["obligations"] == want["obligations"] == {}


# ---- the committed ledgers ----


def test_committed_ledger_covers_registry():
    """``verify --check-ledger``'s invariant on the port's committed
    ledger: every registered join has a matching, non-refuted verdict,
    and every one is proved over a closed domain."""
    led = ledger.load()
    assert led is not None, "crdt_tpu_torch/analysis/verdicts.json missing"
    problems, stale = ledger.check(led)
    assert problems == [] and stale == []
    registry = registered_joins()
    assert set(registry) == set(led["joins"])
    for name, e in led["joins"].items():
        assert e["verdict"] == "proved" and e["domain"]["closed"], name


def test_committed_ledger_equals_jax_committed_ledger():
    """Join for join, the port's committed ledger and the JAX package's
    agree on the verdict, the domain (states, closed, closure rounds,
    source), every law's verdict and space, the obligations, the parts
    and the combinator (the fingerprints differ: one traces a jaxpr, the
    other an aten graph)."""
    mine = ledger.load()["joins"]
    theirs = jledger.load()["joins"]
    assert set(mine) == set(theirs) and len(mine) == 21
    for name in sorted(mine):
        a, b = mine[name], theirs[name]
        assert a["verdict"] == b["verdict"], name
        assert a["domain"] == b["domain"], name
        assert {k: (v["holds"], v["space"]) for k, v in a["laws"].items()} == \
            {k: (v["holds"], v["space"]) for k, v in b["laws"].items()}, name
        assert {k: (v["holds"], v["space"]) for k, v in a["obligations"].items()} == \
            {k: (v["holds"], v["space"]) for k, v in b["obligations"].items()}, name
        assert (a["parts"], a["combinator"]) == (b["parts"], b["combinator"]), name


def test_verified_joins_reflects_ledger():
    verified = joins_mod.verified_joins()
    assert set(verified) == set(registered_joins())
    assert all(s.verified for s in verified.values())


def _tiny_registry():
    zi = lambda d: torch.zeros(2, dtype=torch.int32, device=d)  # noqa: E731
    zb = lambda d: torch.zeros(2, dtype=torch.bool, device=d)  # noqa: E731
    return {
        "tmax": _spec("tmax", torch.maximum, zi,
                      lambda d: [torch.tensor([v, 0], dtype=torch.int32, device=d)
                                 for v in (1, 2)]),
        "tor": _spec("tor", torch.logical_or, zb,
                     lambda d: [torch.tensor([True, False], device=d)]),
    }


def test_ledger_cache_skips_unchanged_joins():
    reg = _tiny_registry()
    led, recomputed = ledger.compute(registry=reg, device="cpu")
    assert sorted(recomputed) == ["tmax", "tor"]
    assert all(e["verdict"] == "proved" for e in led["joins"].values())
    before = prove.blast_call_count()
    led2, recomputed = ledger.compute(cached=led, registry=reg, device="cpu")
    assert recomputed == [] and prove.blast_call_count() == before
    assert led2["joins"] == led["joins"]
    led["joins"]["tmax"]["fingerprint"] = "0" * 16
    _, recomputed = ledger.compute(cached=led, registry=reg, device="cpu")
    assert recomputed == ["tmax"] and prove.blast_call_count() == before + 1


def test_fingerprint_tracks_join_body():
    zi = lambda d=None: torch.zeros(2, dtype=torch.int32, device=d)  # noqa: E731

    def spec(fn, zero=zi):
        return JoinSpec("t", fn, lambda device=None: (zero(device), zero(device)),
                        neutral=zero)

    a, b = spec(torch.maximum), spec(torch.minimum)
    c = spec(lambda x, y: torch.maximum(y, x))  # operands swapped: canonical
    d = spec(lambda x, y: torch.maximum(x, y) + 1)
    wide = spec(torch.maximum, lambda d=None: torch.zeros(3, dtype=torch.int32, device=d))
    fps = [prove.join_fingerprint(s) for s in (a, b, c, d, wide)]
    assert fps[0] == fps[2]
    assert len({fps[0], fps[1], fps[3], fps[4]}) == 4
    assert prove.join_fingerprint(registered_joins()["rseq"]) == \
        ledger.load()["joins"]["rseq"]["fingerprint"]


def test_composite_verdict_downgrades_with_weak_part():
    entries = {
        "leaf": {"verdict": "assumed", "parts": [], "reason": "domain capped"},
        "comp": {"verdict": "proved", "parts": ["leaf"]},
    }
    ledger._downgrade_composites(entries)
    assert entries["comp"]["verdict"] == "assumed"
    assert "leaf" in entries["comp"]["reason"]


def test_domain_closure_is_exhaustive():
    """A closed domain really is join-closed, and its states equal JAX's
    domain for the same join, state for state."""
    from crdt_tpu.analysis.verify.domains import build_domain as jbuild

    reg = registered_joins()
    dom = build_domain(reg["gcounter"], device="cpu")
    assert dom.closed
    keys = {state_key(s) for s in dom.states}
    for a in dom.states:
        for b in dom.states:
            assert state_key(reg["gcounter"].join(a, b)) in keys
    jdom = jbuild(j_registered()["gcounter"])
    assert (len(dom.states), dom.rounds, dom.source) == \
        (len(jdom.states), jdom.rounds, jdom.source)
    for t, j in zip(dom.states, jdom.states):
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))


# ---- the verify CLI ----


def test_verify_cli_exit_codes(tmp_path, monkeypatch, capsys):
    reg = _tiny_registry()
    monkeypatch.setattr(joins_mod, "registered_joins", lambda: reg)
    lp = tmp_path / "verdicts.json"
    dev = ["--device", "cpu"]

    # no ledger yet: the gate is red, a recompute is green
    assert cli.main(["verify", "--check-ledger", "--ledger", str(lp)]) == 1
    assert cli.main(["verify", "--write-ledger", "--ledger", str(lp), *dev]) == 0
    assert lp.exists()
    assert cli.main(["verify", "--check-ledger", "--ledger", str(lp)]) == 0

    # a refuted join fails both the recompute and the gate, and the SARIF
    # export carries the CRDT301 result
    reg["bad_sat"] = _sat_spec()
    sarif_path = tmp_path / "out.sarif"
    assert cli.main(["verify", "--write-ledger", "--ledger", str(lp), *dev]) == 1
    assert cli.main(["verify", "--check-ledger", "--ledger", str(lp),
                     "--sarif", str(sarif_path)]) == 1
    doc = json.loads(sarif_path.read_text())
    assert doc["version"] == "2.1.0"
    assert any(r["ruleId"] == "CRDT301" for r in doc["runs"][0]["results"])

    # dropping the bad join leaves a stale entry, which does NOT fail
    del reg["bad_sat"]
    assert cli.main(["verify", "--check-ledger", "--ledger", str(lp)]) == 0

    # body drift (same name, another computation) re-reddens the gate
    reg["tmax"] = JoinSpec("tmax", lambda a, b: torch.maximum(a, b) + 1,
                           reg["tmax"].example, neutral=reg["tmax"].neutral)
    capsys.readouterr()
    assert cli.main(["verify", "--check-ledger", "--ledger", str(lp), "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert any("'tmax' drifted" in p for p in out["problems"])
    assert [f["rule"] for f in out["findings"]] == ["CRDT302"]


def test_verify_cli_needs_a_card_or_a_device_and_refuses_the_linter(monkeypatch, capsys):
    """Without a card and without --device a recompute raises (no quiet
    fallback to the CPU); the lint subcommands exit 2 naming item 8."""
    monkeypatch.setattr(joins_mod, "registered_joins", _tiny_registry)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["verify", "--no-cache", "--ledger", "/nonexistent/verdicts.json"])
    assert cli.main([]) == 2 and cli.main(["--check-baseline"]) == 2
    assert "ROADMAP Queue 1 item 8" in capsys.readouterr().err


def test_committed_ledger_gate_passes_through_the_cli(capsys):
    assert cli.main(["verify", "--check-ledger"]) == 0
    assert "ledger gate ok — 21 join(s), 0 problem(s)" in capsys.readouterr().out


# ---- the witnessed-race detector ----


class _Box:
    def __init__(self):
        self.val = 0
        self.items = []


def _hammer(box, n=200):
    for _ in range(n):
        box.val += 1
        box.items.append(1)


def test_race_detector_catches_planted_race():
    assert race.install(watch=[(_Box, "val"), (_Box, "items")]) > 0
    try:
        box = _Box()
        ts = [threading.Thread(target=_hammer, args=(box,)) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        ws = race.witnesses()
        assert ws, "two unsynchronized writers produced no witness"
        w = ws[0]
        assert w.cls == "_Box" and w.attr in ("val", "items")
        assert any("_hammer" in line for line in w.prior_stack)
        assert any("_hammer" in line for line in w.current_stack)
        assert race.access_counts()["_Box.val"]["writes"] >= 2
    finally:
        race.uninstall()
    box2 = _Box()  # uninstalled: stale traced wrappers are inert
    box2.val = 5
    box2.items.append(1)
    assert (box2.val, box2.items) == (5, [1])


def test_race_detector_accepts_lock_discipline():
    assert race.install(watch=[(_Box, "val"), (_Box, "items")]) > 0
    try:
        box = _Box()
        lock = threading.Lock()  # created while installed: traced

        def worker():
            for _ in range(200):
                with lock:
                    box.val += 1
                    box.items.append(1)

        ts = [threading.Thread(target=worker) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert race.witnesses() == []
        assert box.val == 400
        assert race.access_counts()["_Box.val"]["writes"] >= 400
    finally:
        race.uninstall()


def test_race_detector_accepts_fork_join_ordering():
    assert race.install(watch=[(_Box, "val")]) > 0
    try:
        box = _Box()
        box.val = 1
        t = threading.Thread(target=lambda: setattr(box, "val", 2))
        t.start()
        t.join()
        box.val = 3
        assert race.witnesses() == []
    finally:
        race.uninstall()


def test_race_detector_accepts_event_handoff():
    assert race.install(watch=[(_Box, "val")]) > 0
    try:
        box = _Box()
        ev = threading.Event()
        got = []

        def producer():
            box.val = 42
            ev.set()

        def consumer():
            ev.wait(5.0)
            got.append(box.val)

        tp, tc = threading.Thread(target=producer), threading.Thread(target=consumer)
        tc.start()
        tp.start()
        tp.join()
        tc.join()
        assert got == [42] and race.witnesses() == []
    finally:
        race.uninstall()


def test_race_detector_runtime_watchpoints_resolve():
    """DEFAULT_WATCH resolves against the port's live runtime modules,
    class for class and attribute for attribute as JAX's; the static
    bridge waits for the lint tiers."""
    import inspect

    from crdt_tpu.analysis.verify import race as jrace

    points = race._resolve_default_watch()
    assert len(points) == len(jrace._resolve_default_watch()) >= 7
    assert [(c.__name__, a) for c, a in points] == \
        [(c.__name__, a) for c, a in jrace._resolve_default_watch()]
    for cls, attr in points:
        assert cls.__module__.startswith("crdt_tpu_torch.")
        src = inspect.getsource(cls.__init__)
        slots = getattr(cls, "__slots__", ())
        assert attr in slots or hasattr(cls, attr) or f"self.{attr}" in src, (cls, attr)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        race.watch_from_static()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        race.install(include_static=True)
    assert not race._ENABLED


@pytest.mark.slow
def test_race_detector_clean_on_threaded_runtime():
    """A small nemesis soak under the detector: zero witnesses with live
    instrumentation."""
    from crdt_tpu_torch.harness import nemesis_soak

    assert race.install() > 0
    try:
        nemesis_soak.run_soak(seed=3, nodes=2, steps=40, device="cpu")
        rpt = race.report()
        assert rpt["witness_count"] == 0, "\n".join(rpt["witnesses"])
        assert sum(c["reads"] + c["writes"] for c in rpt["access_counts"].values()) > 0
    finally:
        race.uninstall()


def test_jax_planted_specs_refute_alike():
    """The planted joins refute on the same laws in both packages."""
    def jspec(name, join, zero, small):
        return jprove.prove_spec(JJoinSpec(name, join, lambda: (zero(), zero()),
                                           neutral=zero, small=small), registry={})

    from crdt_tpu.ops.joins import JoinSpec as JJoinSpec

    javg = jspec("bad_avg", lambda a, b: 0.6 * a + 0.4 * b,
                 lambda: jnp.zeros((2,), jnp.float32),
                 lambda: [jnp.asarray([v, 0.0], jnp.float32) for v in (0.0, 1.0, 2.0)])
    jsat = jspec("bad_sat", lambda a, b: jnp.minimum(a + b, jnp.int8(100)),
                 lambda: jnp.zeros((2,), jnp.int8),
                 lambda: [jnp.asarray([v, 0], jnp.int8) for v in (0, 3, 80)])
    for mine, theirs in ((prove.prove_spec(_avg_spec(), registry={}, device="cpu"), javg),
                         (prove.prove_spec(_sat_spec(), registry={}, device="cpu"), jsat)):
        assert mine["refuted_laws"] == theirs["refuted_laws"]
        assert mine["domain"] == theirs["domain"]
        for law in mine["refuted_laws"]:  # the same first counterexample
            assert mine["laws"][law]["counterexample"] == \
                theirs["laws"][law]["counterexample"], law
