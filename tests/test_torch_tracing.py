"""The port's tracing hooks (crdt_tpu_torch.utils.tracing on
torch.profiler) write traces, and the swarm path carries the JAX
package's three named regions around its kernel launches: the OpLog and
RSeq converges and the GC barrier, whose results under a trace equal the
JAX package's.  Follows tests/test_tracing.py."""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import oplog_columnar as joc
from crdt_tpu.models import rseq as jrseq
from crdt_tpu.models import tomb_gc as jgc
from crdt_tpu.parallel import swarm as jswarm
from crdt_tpu_torch.models import oplog_columnar as toc
from crdt_tpu_torch.models import rseq as trseq
from crdt_tpu_torch.models import rseq_columnar as trc
from crdt_tpu_torch.models import tomb_gc as tgc
from crdt_tpu_torch.parallel import swarm as tswarm
from crdt_tpu_torch.utils import tracing
from tests.test_torch_oplog_columnar import BITS, _assert_col, _batch, _op_pool
from tests.test_torch_rseq_columnar import swarm as rseq_swarm
from tests.test_torch_tomb_gc import CAP, JAD, TAD, assert_gc, edited_swarm, gc_j


def _names(logdir) -> set:
    files = [p for p in pathlib.Path(logdir).rglob("*.json") if p.is_file()]
    assert files, "no trace files written"
    return {e.get("name") for f in files for e in json.loads(f.read_text())["traceEvents"]}


def test_trace_to_captures_profile(tmp_path):
    """trace_to around an OpLog swarm converge writes a Chrome trace
    holding the caller's region and the converge's own; the traced
    converge equals the JAX package's (Pallas in interpret mode)."""
    rng = np.random.default_rng(3)
    j, t = _batch(rng, 4, 16, _op_pool(rng, 24))
    logdir = tmp_path / "trace"
    with tracing.trace_to(str(logdir)):
        with tracing.trace_region("converge"):
            tc, tn = toc.converge_checked(toc.stack(t, BITS))
    assert {"converge", "oplog_columnar.converge"} <= _names(logdir)
    jc, jn = joc.converge_checked(joc.stack(j, BITS), interpret=True)
    _assert_col(jc, tc)
    assert int(jn) == int(tn)


def test_trace_region_is_transparent():
    with tracing.trace_region("noop"):
        x = torch.arange(4).sum()
    assert int(x) == 6
    with pytest.raises(RuntimeError, match="no trace"):
        tracing.stop_trace()


def test_start_trace_twice_refuses(tmp_path):
    tracing.start_trace(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            tracing.start_trace(str(tmp_path))
    finally:
        path = tracing.stop_trace()
    assert pathlib.Path(path).parent == tmp_path


def test_rseq_converge_and_gc_barrier_regions_match_jax(tmp_path):
    """The RSeq converge and the GC barrier (its columnar converge inside)
    under one trace: both regions named as in the JAX package, and the
    barrier's result equal to the JAX package's generic barrier."""
    st = rseq_swarm(6, 4, 10)
    g = edited_swarm(2)
    alive = torch.tensor([True, True, False, True])
    with tracing.trace_to(str(tmp_path)):
        got, nu = trc.converge_checked(trc.stack(st))
        out = tgc.gc_round(tswarm.make(g, alive), TAD, trseq.empty(CAP, device="cpu"))
    assert {"rseq_columnar.converge", "tomb_gc.barrier"} <= _names(tmp_path)
    assert int(nu) <= CAP and got.keys.shape[-1] == st.keys.shape[0]
    want = jgc.gc_round(jswarm.make(gc_j(g), jnp.asarray(alive.numpy())), JAD,
                        jrseq.empty(CAP), engine="generic")
    assert_gc(want.state, out.state)
