"""The port's crdtlint (crdt_tpu_torch.analysis) against the JAX
package's (crdt_tpu.analysis), the twins of tests/test_analysis.py: every
fixture source gives equal (rule, line, scope, detail, severity) from both
packages' checkers; the torch spellings the port adds fire in the port
only; the planted defective registry gives JAX's {scope: rule} map on
make_fx graphs; the planted hazards trip JAX's rules with JAX's details;
both real registries are clean; the fingerprint scheme, the baseline
diff, the CLI's exit codes (one argv to both mains) and the SARIF shape
match; the port's tree is clean against its committed baseline."""
import json
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from crdt_tpu import analysis as janalysis
from crdt_tpu.analysis import __main__ as jcli
from crdt_tpu.analysis import ast_checks as jast
from crdt_tpu.analysis import baseline as jbaseline
from crdt_tpu.analysis import concurrency as jconc
from crdt_tpu.analysis import Finding as JFinding
from crdt_tpu_torch import analysis
from crdt_tpu_torch.analysis import __main__ as cli
from crdt_tpu_torch.analysis import ast_checks, baseline, concurrency, fx_checks
from crdt_tpu_torch.analysis import Finding
from crdt_tpu_torch.analysis.verify import hazards, prove
from crdt_tpu_torch.ops import joins as joins_mod
from crdt_tpu_torch.ops.joins import JoinSpec


def _key(findings):
    return sorted((f.rule, f.line, f.scope, f.detail, f.severity) for f in findings)


def _write(tmp_path, source, relpath):
    p = tmp_path / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return p


# ---- tests/test_analysis.py's fixture sources ----

#: name -> (source, the rules JAX's test expects, layer)
FIXTURES = {
    "donation_after_use": ("""
        from crdt_tpu.ops import joins

        def round(a, b):
            merge = joins.donating(join)
            out = merge(a, b)
            return out + a
    """, ["CRDT001"], "ast"),
    "donation_rebinding": ("""
        from crdt_tpu.ops import joins

        def round(a, b):
            merge = joins.donating(join)
            a = merge(a, b)
            return a
    """, [], "ast"),
    "jit_donate_argnums": ("""
        import jax

        def round(a, b):
            f = jax.jit(step, donate_argnums=(1,))
            out = f(a, b)
            return out + b
    """, ["CRDT001"], "ast"),
    "jit_in_loop": ("""
        import jax

        def rounds(xs):
            outs = []
            for x in xs:
                f = jax.jit(step)
                outs.append(f(x))
            return outs
    """, ["CRDT002"], "ast"),
    "jit_hoisted": ("""
        import jax

        def rounds(xs):
            f = jax.jit(step)
            return [f(x) for x in xs]
    """, [], "ast"),
    "host_sync_hot": ("""
        import numpy as np

        def peek(x):
            return np.asarray(x)
    """, ["CRDT003"], "hot"),
    "host_sync_cold": ("""
        import numpy as np

        def peek(x):
            return np.asarray(x)
    """, [], "cold"),
    "silent_except": ("""
        def poll(url):
            try:
                fetch(url)
            except Exception:
                pass
    """, ["CRDT004"], "ast"),
    "handled_except": ("""
        def poll(url, events):
            try:
                fetch(url)
            except Exception as e:
                events.emit("poll_failed", error=str(e))
    """, [], "ast"),
    "unlocked_thread_mutation": ("""
        import threading

        class Agent:
            def start(self):
                threading.Thread(target=self._loop).start()

            def _loop(self):
                self.errors.append("boom")
    """, ["CRDT201"], "conc"),
    "locked_thread_mutation": ("""
        import threading

        class Agent:
            def start(self):
                threading.Thread(target=self._loop).start()

            def _loop(self):
                with self._lock:
                    self.errors.append("boom")
    """, [], "conc"),
}

_PLACES = {"ast": ("fixture.py", "fixture.py"),
           "hot": ("crdt_tpu/ops/fixture.py", "crdt_tpu_torch/ops/fixture.py"),
           "cold": ("crdt_tpu/harness/fixture.py", "crdt_tpu_torch/harness/fixture.py"),
           "conc": ("agent.py", "agent.py")}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_equal_jax(tmp_path, name):
    source, want, layer = FIXTURES[name]
    jrel, trel = _PLACES[layer]
    jp, tp = _write(tmp_path / "j", source, jrel), _write(tmp_path / "t", source, trel)
    if layer == "conc":
        got = concurrency.check_files([tp], tmp_path / "t")
        ref = jconc.check_files([jp], tmp_path / "j")
    else:
        got = ast_checks.check_file(tp, tmp_path / "t")
        ref = jast.check_file(jp, tmp_path / "j")
    assert sorted(f.rule for f in got) == want
    assert _key(got) == _key(ref)
    assert [f.message for f in got] == [f.message for f in ref]


# ---- the torch spellings the port adds ----

TORCH_FIXTURES = {
    "cpu": ("def peek(x):\n    return x.cpu()\n", ["CRDT003"]),
    "tolist": ("def peek(x):\n    return x.tolist()\n", ["CRDT003"]),
    "cpu_numpy_once": ("def peek(x):\n    return x.cpu().numpy()\n", ["CRDT003"]),
    "synchronize": ("import torch\n\ndef wait():\n    torch.cuda.synchronize()\n",
                    ["CRDT003"]),
    "int_of_reduction": ("def count(x):\n    return int(x.sum())\n", ["CRDT003"]),
    "int_of_item_once": ("def count(x):\n    return int(x.sum().item())\n", ["CRDT003"]),
    "bool_of_any": ("def seen(x):\n    return bool((x > 0).any())\n", ["CRDT003"]),
    "host_ints_clean": ("def sizes(xs, rng, cfg):\n"
                        "    return int(len(xs)), int(rng.integers(4)), int(cfg.get('n'))\n",
                        []),
    "numpy_tolist_not_again": ("import numpy as np\n\ndef ids(xs):\n"
                               "    return np.asarray(xs).tolist()\n", ["CRDT003"]),
    "torch_compile_in_loop": ("import torch\n\ndef rounds(xs):\n    for x in xs:\n"
                              "        f = torch.compile(step)\n        f(x)\n", ["CRDT002"]),
    "jit_script_decorator_in_loop": ("import torch\n\ndef rounds(xs):\n    for x in xs:\n"
                                     "        @torch.jit.script\n"
                                     "        def f(y):\n            return y\n", ["CRDT002"]),
    "load_inline_in_loop": ("from torch.utils import cpp_extension\n\n"
                            "def builds(srcs):\n    for s in srcs:\n"
                            "        cpp_extension.load_inline('m', s)\n", ["CRDT002"]),
    "cached_build_and_re_compile_clean": ("import re\n\ndef rounds(names, _build):\n"
                                          "    for n in names:\n        _build.load(n)\n"
                                          "        re.compile(n)\n", []),
}


#: the torch fixtures whose sync JAX's checker also sees (.item(), np.asarray)
JAX_SEES = {"int_of_item_once", "numpy_tolist_not_again"}


@pytest.mark.parametrize("name", sorted(TORCH_FIXTURES))
def test_torch_spellings_fire_in_the_port(tmp_path, name):
    """Torch's host syncs and compile-cache constructions are the port's
    additions to CRDT002/CRDT003 (JAX's checker sees none of them but
    ``.item()`` and ``np.asarray``); host values are not syncs, and one
    sync is flagged once."""
    source, want = TORCH_FIXTURES[name]
    tp = _write(tmp_path / "t", source, "crdt_tpu_torch/ops/fixture.py")
    jp = _write(tmp_path / "j", source, "crdt_tpu/ops/fixture.py")
    assert sorted(f.rule for f in ast_checks.check_file(tp, tmp_path / "t")) == want
    jax_rules = sorted(f.rule for f in jast.check_file(jp, tmp_path / "j"))
    assert jax_rules == (["CRDT003"] if name in JAX_SEES else [])


# ---- the join-graph tier ----


def _example(device=None):
    return (torch.zeros(4, dtype=torch.int32, device=device),
            torch.zeros(4, dtype=torch.int32, device=device))


def _bad_registry():
    """JAX's _bad_registry in torch: a host sync inside the join (torch's
    form of a callback), a concatenation, a claimed-commutative
    ``return a``, and a composite claiming commutativity over an
    honestly-registered select leaf."""

    def impure(a, b):
        m = torch.maximum(a, b)
        return m if m.sum().item() >= 0 else m

    def not_closed(a, b):
        return torch.cat([a, b])

    def asymmetric(a, b):
        return a

    def select_max(a, b):
        return torch.where(a > b, a, b)

    return {
        "impure": JoinSpec("impure", impure, _example),
        "not_closed": JoinSpec("not_closed", not_closed, _example),
        "asymmetric": JoinSpec("asymmetric", asymmetric, _example,
                               structurally_commutative=True),
        "select_leaf": JoinSpec("select_leaf", select_max, _example),
        "bad_composite": JoinSpec("bad_composite", torch.maximum, _example,
                                  structurally_commutative=True,
                                  parts=("select_leaf", "select_leaf")),
    }


def test_graph_checks_catch_planted_defects(monkeypatch):
    monkeypatch.setattr(joins_mod, "registered_joins", _bad_registry)
    findings = fx_checks.check_registered_joins(analysis.repo_root())
    # tests/test_analysis.py::test_jaxpr_checks_catch_planted_defects's map
    assert {f.scope: f.rule for f in findings} == {
        "impure": "CRDT101",
        "not_closed": "CRDT102",
        "asymmetric": "CRDT103",
        "bad_composite": "CRDT104",
    }
    (sync,) = [f for f in findings if f.scope == "impure"]
    assert sync.detail == "impure|_local_scalar_dense"


def test_graph_purity_allows_only_aten_and_getitem():
    """A sort's tuple is unpacked by operator.getitem (allowed); a call
    to anything but an aten/prims operator is CRDT101."""
    import operator

    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(lambda a, b: torch.sort(torch.maximum(a, b))[0])(*_example())
    kinds = {n.target for n in gm.graph.nodes if n.op == "call_function"}
    assert operator.getitem in kinds
    assert all(fx_checks._impurity(n) == "" for n in gm.graph.nodes)
    gm.graph.call_function(print, ("x",))
    assert [fx_checks._impurity(n) for n in gm.graph.nodes
            if n.op == "call_function" and n.target is print] == ["print"]


def _jspec(name, join, zero):
    from crdt_tpu.ops.joins import JoinSpec as JJoinSpec

    return JJoinSpec(name, join, lambda: (zero(), zero()), neutral=zero)


def _hazards(spec):
    gm, _, _ = prove.trace_join(spec)
    return hazards.check_join_hazards(spec.name, spec, gm, "fixture.py", 1)


def _jhazards(spec):
    from crdt_tpu.analysis.verify import hazards as jhazards

    closed = jax.make_jaxpr(spec.join)(*spec.example())
    return jhazards.check_join_hazards(spec.name, spec, closed.jaxpr, "fixture.py", 1)


def test_planted_joins_trip_the_hazard_pass_like_jax():
    """tests/test_verify.py's planted joins: the weighted mean trips
    CRDT105 and the wrapping int8 add CRDT107, with JAX's details (op and
    dtype); a torch.rand inside a join trips CRDT106."""
    avg = JoinSpec("bad_avg", lambda a, b: 0.6 * a + 0.4 * b,
                   lambda device=None: (torch.zeros(2, device=device),
                                        torch.zeros(2, device=device)))
    javg = _jspec("bad_avg", lambda a, b: 0.6 * a + 0.4 * b,
                  lambda: jnp.zeros((2,), jnp.float32))
    sat = JoinSpec("bad_sat",
                   lambda a, b: torch.minimum(a + b, torch.tensor(100, dtype=torch.int8)),
                   lambda device=None: tuple(torch.zeros(2, dtype=torch.int8, device=device)
                                             for _ in range(2)))
    jsat = _jspec("bad_sat", lambda a, b: jnp.minimum(a + b, jnp.int8(100)),
                  lambda: jnp.zeros((2,), jnp.int8))
    for mine, theirs, rule in ((avg, javg, "CRDT105"), (sat, jsat, "CRDT107")):
        got, want = _hazards(mine), _jhazards(theirs)
        assert rule in {f.rule for f in got}
        assert _key(got) == _key(want)
    noisy = JoinSpec("bad_rand",
                     lambda a, b: torch.maximum(a, b) + (torch.rand(4) * 0).to(torch.int32),
                     _example)
    assert "CRDT106" in {f.rule for f in _hazards(noisy)}
    counted = JoinSpec("bad_arange", lambda a, b: torch.maximum(a, b) + torch.arange(4),
                       _example, structurally_commutative=True)
    assert {f.detail for f in _hazards(counted)} == {"bad_arange|arange"}


def test_real_registries_are_clean_and_complete():
    """The acceptance invariant in both packages: every registered join
    traces pure, closed and swap-symmetric where claimed, with no
    hazard; the two registries hold the same joins and claims."""
    from crdt_tpu.analysis import jaxpr_checks
    from crdt_tpu.ops.joins import registered_joins as j_registered

    registry, jregistry = joins_mod.registered_joins(), j_registered()
    assert set(registry) == set(jregistry) and len(registry) == 21
    for name, spec in registry.items():
        assert spec.structurally_commutative == jregistry[name].structurally_commutative
        assert spec.parts == jregistry[name].parts
    assert fx_checks.check_registered_joins(analysis.repo_root()) == []
    assert jaxpr_checks.check_registered_joins(janalysis.repo_root()) == []


# ---- baseline, CLI, SARIF ----


def test_fingerprint_scheme_equals_jax():
    fields = dict(rule="CRDT003", path="x/ops/x.py", message="m", scope="f",
                  detail="np.asarray(x)")
    a, b = Finding(line=10, **fields), Finding(line=99, **fields)
    assert baseline.fingerprint(a) == baseline.fingerprint(b) == \
        jbaseline.fingerprint(JFinding(line=10, **fields))
    assert baseline.fingerprint(a, 1) == jbaseline.fingerprint(JFinding(line=10, **fields), 1)


def test_baseline_diff_flags_new_findings_like_jax(tmp_path):
    def run(mod, finding, d):
        known = finding(rule="CRDT003", path="a.py", line=1, message="m",
                        scope="f", detail="d")
        fresh = finding(rule="CRDT004", path="b.py", line=2, message="m2",
                        scope="g", detail="e")
        bl = d / "baseline.json"
        d.mkdir()
        mod.save([known], bl)
        new, stale = mod.diff([known, fresh], bl)
        new2, stale2 = mod.diff([fresh], bl)
        return ([f.rule for f in new], stale, [f.rule for f in new2],
                [e["rule"] for e in stale2], json.loads(bl.read_text())["entries"])

    got = run(baseline, Finding, tmp_path / "t")
    want = run(jbaseline, JFinding, tmp_path / "j")
    assert got[:4] == (["CRDT004"], [], ["CRDT004"], ["CRDT003"])
    assert got == want


_BAD = ("def poll(u):\n"
        "    try:\n"
        "        fetch(u)\n"
        "    except Exception:\n"
        "        pass\n")


def test_cli_exit_codes_equal_jax(tmp_path, capsys):
    """One argv to both mains: a clean fixture passes the gate with an
    empty baseline, a silent except fails it; --write-baseline then
    greens it, a rules subset ignores the others, --list-rules lists the
    same rule ids."""
    clean = tmp_path / "clean.py"
    clean.write_text("def f(x):\n    return x + 1\n")
    bad = tmp_path / "bad.py"
    bad.write_text(_BAD)
    cases = [
        lambda bl: [str(clean), "--no-jaxpr", "--check-baseline", "--baseline", str(bl)],
        lambda bl: [str(bad), "--no-jaxpr", "--check-baseline", "--baseline", str(bl)],
        lambda bl: [str(bad), "--no-jaxpr", "--rules", "CRDT210,CRDT211,CRDT212,CRDT213",
                    "--check-baseline", "--baseline", str(bl)],
        lambda bl: [str(bad), "--no-jaxpr", "--write-baseline", "--baseline", str(bl)],
        lambda bl: [str(bad), "--no-jaxpr", "--check-baseline", "--baseline", str(bl)],
        lambda bl: [str(bad), "--no-jaxpr", "--json"],
        lambda bl: [str(clean), "--check-baseline", "--baseline", str(bl)],
    ]
    for tag, main in (("t", cli.main), ("j", jcli.main)):
        bl = tmp_path / f"{tag}.json"
        codes = [main(argv(bl)) for argv in cases]
        assert codes == [0, 1, 0, 0, 0, 1, 0], tag
    capsys.readouterr()
    assert cli.main(["--list-rules"]) == jcli.main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.splitlines()
    ids = [ln.split()[0] for ln in lines]
    assert ids[:len(ids) // 2] == ids[len(ids) // 2:] == sorted(analysis.RULES)


def test_sarif_output_shape(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(_BAD)
    docs = []
    for tag, main in (("t", cli.main), ("j", jcli.main)):
        out = tmp_path / f"{tag}.sarif"
        assert main([str(bad), "--no-jaxpr", "--sarif", str(out)]) == 1
        docs.append(json.loads(out.read_text()))
    doc = docs[0]
    assert doc["version"] == "2.1.0"
    (run,) = doc["runs"]
    assert run["tool"]["driver"]["name"] == "crdtlint"
    (res,) = run["results"]
    assert res["ruleId"] == "CRDT004" and res["level"] == "error"
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith("bad.py")
    assert loc["region"]["startLine"] >= 1
    assert res["partialFingerprints"]["crdtlint/v1"]
    assert run["tool"]["driver"]["rules"][res["ruleIndex"]]["id"] == "CRDT004"
    assert res == docs[1]["runs"][0]["results"][0]


def test_rules_table_matches_jax():
    assert set(analysis.RULES) == set(janalysis.RULES)
    assert analysis.SEVERITY == janalysis.SEVERITY


# ---- the port's own tree ----


def test_tree_is_clean_against_committed_baseline():
    """What ``--check-baseline`` (and chip_smoke phase 25) enforces: zero
    new findings on the port's tree vs crdt_tpu_torch/analysis/baseline.json,
    no error-severity finding, and only warns in the file."""
    findings = analysis.run_all()
    new, stale = baseline.diff(findings)
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == []
    assert [f for f in findings if f.severity == "error"] == []
    entries = baseline.load().values()
    assert entries and {analysis.SEVERITY[e["rule"]] for e in entries} == {"warn"}
    assert all(e["path"].startswith("crdt_tpu_torch/") for e in entries)
