"""The port's soaks (crdt_tpu_torch.harness.gc_soak, seq_soak) against the
JAX package's on the same seeds at tests/test_gc_soak.py's and
tests/test_seq_soak.py's short sizes: equal reports (every step's mirror
check runs inside both).  JAX's sequence soak runs its generic engine
(its auto engine is interpret-mode Pallas here; tests/test_rseq_engine.py
pins generic == auto bit for bit); the port's auto engine (the kernels'
CPU twins) must give the generic report."""
import dataclasses

import pytest

from crdt_tpu.harness import gc_soak as jgc
from crdt_tpu.harness import seq_soak as jseq
from crdt_tpu_torch.harness import gc_soak as tgc
from crdt_tpu_torch.harness import seq_soak as tseq

CPU = "cpu"

PRESSURE_SET = dict(n=3, seed=7, capacity=128, p_add=0.35, p_remove=0.25, p_join=0.2,
                    p_kill=0.0, p_revive=0.0, p_barrier=0.2)
PRESSURE_MAP = dict(n=3, seed=5, p_update=0.3, p_remove=0.22, p_join=0.2, p_kill=0.0,
                    p_revive=0.0, p_snapshot=0.05, p_restore=0.05, p_barrier=0.18)
RESTARTS_SEQ = dict(n=3, seed=5, capacity=256, p_insert=0.27, p_run=0.03, p_delete=0.22,
                    p_join=0.2, p_kill=0.0, p_revive=0.0, p_restart=0.1, p_barrier=0.18)


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert str(a) == str(b)


@pytest.mark.parametrize("kw,steps", [(dict(n=4, seed=s, capacity=256), 150) for s in range(3)]
                         + [(PRESSURE_SET, 400)], ids=["seed0", "seed1", "seed2", "pressure"])
def test_set_soak_report_matches_jax(kw, steps):
    want = jgc.SetSoakRunner(**kw).run(steps)
    got = tgc.SetSoakRunner(**kw, device=CPU).run(steps)
    _same(want, got)
    assert got.rows_reclaimed > 0


@pytest.mark.parametrize("kw,steps", [(dict(n=3, seed=s), 200) for s in range(3)]
                         + [(PRESSURE_MAP, 400)], ids=["seed0", "seed1", "seed2", "pressure"])
def test_map_soak_report_matches_jax(kw, steps):
    want = jgc.MapSoakRunner(**kw).run(steps)
    got = tgc.MapSoakRunner(**kw, device=CPU).run(steps)
    _same(want, got)
    assert got.barriers > 0 and got.keys_reset > 0


SEQ_CASES = [(dict(n=3, seed=s, capacity=256), 120) for s in range(2)] + [(RESTARTS_SEQ, 300)]
SEQ_IDS = ["seed0", "seed1", "restarts"]


@pytest.mark.parametrize("kw,steps", SEQ_CASES, ids=SEQ_IDS)
def test_seq_soak_generic_report_matches_jax(kw, steps):
    want = jseq.SeqSoakRunner(**kw, engine="generic").run(steps)
    got = tseq.SeqSoakRunner(**kw, engine="generic", device=CPU).run(steps)
    _same(want, got)
    assert got.inserts > 0 and got.joins > 0


@pytest.mark.parametrize("kw,steps", SEQ_CASES + [(dict(n=3, seed=2, capacity=1024), 80)],
                         ids=SEQ_IDS + ["capacity1024"])
def test_seq_soak_auto_engine_equals_generic(kw, steps):
    """The columnar engine (kernel 1's twin at capacity <= 512, kernels 4
    and 5's above) gives the generic engine's report."""
    auto = tseq.SeqSoakRunner(**kw, engine="auto", device=CPU).run(steps)
    generic = tseq.SeqSoakRunner(**kw, engine="generic", device=CPU).run(steps)
    _same(generic, auto)
