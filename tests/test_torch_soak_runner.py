"""The port's in-process soak (crdt_tpu_torch.harness.soak.SoakRunner)
against the JAX package's on seeds 0-2, with and without scheduled
compaction barriers: the same SoakReport, final state and counters, and
the same propagation summary (obs.provenance.propagation_summary) over the
step-clock histograms.  Both clusters run on a ManualClock advanced one
millisecond a step, so every write's wire timestamp is equal in both."""
import pytest

from crdt_tpu.harness import soak as jsoak
from crdt_tpu.obs import provenance as jprov
from crdt_tpu.utils import clock as jclock
from crdt_tpu.utils import config as jconfig
from crdt_tpu_torch.harness import soak as tsoak
from crdt_tpu_torch.obs import provenance as tprov
from crdt_tpu_torch.utils import clock as tclock
from crdt_tpu_torch.utils import config as tconfig

STEPS = 150


def run(runner, clock):
    for n in runner.cluster.nodes:
        n.clock = clock
    for _ in range(STEPS):
        clock.advance(1)
        runner.step()
    return runner.heal_and_check()


def counters(cluster) -> dict:
    reg = cluster.metrics.registry
    with reg._lock:
        return dict(reg._counters)


@pytest.mark.parametrize("compact_every", [0, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_soak_runner_matches_jax(seed, compact_every):
    kw = dict(n_replicas=4, compact_every=compact_every, log_capacity=64, seed=seed)
    jr = jsoak.SoakRunner(config=jconfig.ClusterConfig(**kw), seed=seed)
    tr = tsoak.SoakRunner(config=tconfig.ClusterConfig(**kw), seed=seed, device="cpu")
    ja, ta = run(jr, jclock.ManualClock()), run(tr, tclock.ManualClock())
    for f in ("steps", "writes_offered", "writes_accepted", "writes_rejected_dead",
              "gossip_rounds", "kills", "revivals", "barriers", "barriers_skipped",
              "rounds_to_converge", "final_state", "pages_admitted"):
        assert getattr(ja, f) == getattr(ta, f), f
    assert ta.writes_accepted and ta.final_state
    assert counters(jr.cluster) == counters(tr.cluster)
    assert {k: v for k, v in ja.metrics.items() if "_p50_ms" not in k
            and not k.startswith(("join_", "last_merge", "seconds_since"))} == \
        {k: v for k, v in ta.metrics.items() if "_p50_ms" not in k
         and not k.startswith(("join_", "last_merge", "seconds_since"))}
    js = jprov.propagation_summary(jr.cluster.metrics.registry)
    ts = tprov.propagation_summary(tr.cluster.metrics.registry)
    steps = {k: v for k, v in js.items() if k.startswith("propagation_steps")}
    assert steps and steps == {k: v for k, v in ts.items() if k.startswith("propagation_steps")}
    assert js["propagation_s_count"] == ts["propagation_s_count"]
    assert len(jr.ledger) == len(tr.ledger)
    if compact_every:
        assert counters(tr.cluster).get(("compactions", ())) or ta.barriers_skipped
