"""A gloo world of ``torch.distributed`` ranks on the CPU for the port's
multi-rank twins (tests/test_torch_mesh.py, test_torch_multihost.py and
the sharded cases of the columnar and GC tests).

:func:`run_world` spawns the ranks once (``torch.multiprocessing.spawn``,
a ``file://`` store under the test's tmp_path, so no TCP port is taken
and xdist workers never collide), and each rank runs every named case of
this module on its shard.  The parent prepares the inputs as numpy
arrays (from the JAX side of a twin), and gets each rank's outputs back
as numpy.  This module and its children import nothing of JAX or of the
JAX package: only torch and the port.

Every rank builds two meshes at start-up: ``mesh4`` over the world of 4
and ``mesh3`` over the first 3 ranks (the ``all_gather`` branch of
``allreduce_join``; rank 3 is not on it and returns None there).
"""
from __future__ import annotations

import datetime
import pickle
import sys
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def run_world(tmp_path: Path, cases: Sequence[Tuple[str, Any]], *,
              init: str = "dist", world: int = WORLD) -> List[Dict[str, Any]]:
    """Run ``cases`` (name, inputs) on every rank of a fresh gloo world;
    returns each rank's {name: output}, in rank order."""
    tmp_path = Path(tmp_path)
    (tmp_path / "inputs.pkl").write_bytes(pickle.dumps(list(cases)))
    mp.spawn(_rank_main, args=(world, str(tmp_path), init), nprocs=world, join=True)
    return [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def _rank_main(rank: int, world: int, tmp: str, init: str) -> None:
    from crdt_tpu_torch.parallel import mesh as mesh_lib, multihost

    store = f"file://{tmp}/store"
    if init == "multihost":
        assert multihost.init_from_env(init_method=store, world_size=world, rank=rank,
                                       device="cpu")
    else:
        dist.init_process_group("gloo", init_method=store, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
    try:
        mesh4 = mesh_lib.make_mesh(device="cpu")
        mesh3 = mesh_lib.make_mesh(3, device="cpu")
        cases = pickle.loads((Path(tmp) / "inputs.pkl").read_bytes())
        out: Dict[str, Any] = {"_jax_imported": any(m == "jax" or m.startswith("jax.")
                                                    or m.startswith("crdt_tpu.")
                                                    for m in sys.modules)}
        for name, inputs in cases:
            out[name] = globals()[name](mesh4, mesh3, inputs)
        (Path(tmp) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def _per_mesh(mesh4, mesh3, inputs, fn):
    """``fn(mesh, inputs[size])`` on each mesh this rank is on."""
    return {size: (None if m is None else fn(m, inputs[size]))
            for size, m in ((4, mesh4), (3, mesh3)) if size in inputs}


def _shard(x: np.ndarray, mesh, axis: int = 0) -> torch.Tensor:
    k = x.shape[axis] // mesh.size
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(mesh.rank * k, (mesh.rank + 1) * k)
    return torch.from_numpy(np.ascontiguousarray(x[tuple(idx)]))


# ---- parallel.mesh ----


def pmax(mesh4, mesh3, inputs):
    from crdt_tpu_torch.models import gcounter
    from crdt_tpu_torch.parallel import mesh as mesh_lib, swarm

    def one(mesh, d):
        s = swarm.make(gcounter.GCounter(counts=torch.from_numpy(d["counts"])),
                       torch.from_numpy(d["alive"]))
        out = mesh_lib.pmax_converge(mesh)(mesh_lib.shard_swarm(s, mesh))
        return out.state.counts.numpy()

    return _per_mesh(mesh4, mesh3, inputs, one)


pmax_alive = pmax


def _oplog(d, lo=None, hi=None):
    from crdt_tpu_torch import convert

    return convert.oplog_from_numpy({f: v[lo:hi] for f, v in d.items()}, device="cpu")


def generic_oplog(mesh4, mesh3, inputs):
    from crdt_tpu_torch import convert
    from crdt_tpu_torch.models import oplog
    from crdt_tpu_torch.parallel import mesh as mesh_lib, swarm

    def one(mesh, d):
        s = swarm.make(_oplog(d["logs"]), torch.from_numpy(d["alive"]))
        cap = d["logs"]["ts"].shape[-1]
        step = mesh_lib.sharded_converge(mesh, oplog.merge, oplog.merge,
                                         oplog.empty(cap, device="cpu"))
        return convert.oplog_to_numpy(step(mesh_lib.shard_swarm(s, mesh)).state)

    return _per_mesh(mesh4, mesh3, inputs, one)


def allreduce(mesh4, mesh3, inputs):
    from crdt_tpu_torch import convert
    from crdt_tpu_torch.models import oplog
    from crdt_tpu_torch.parallel import mesh as mesh_lib

    def one(mesh, d):
        x = _oplog(d["logs"], mesh.rank, mesh.rank + 1)
        x = oplog.OpLog(*(getattr(x, f)[0] for f in oplog._FIELDS))
        cap = d["logs"]["ts"].shape[-1]
        out = mesh_lib.allreduce_join(oplog.merge, x, mesh,
                                      oplog.empty(cap, device="cpu"))
        return convert.oplog_to_numpy(out)

    return _per_mesh(mesh4, mesh3, inputs, one)


def gossip(mesh4, mesh3, inputs):
    """The twin of JAX's GSPMD gossip round: all-gather the shards, then
    the port's plain gossip_round on the gathered rows."""
    from crdt_tpu_torch.models import gcounter
    from crdt_tpu_torch.parallel import mesh as mesh_lib, swarm

    def one(mesh, d):
        s = mesh_lib.shard_swarm(swarm.make(gcounter.GCounter(
            counts=torch.from_numpy(d["counts"]))), mesh)
        full = swarm.Swarm(state=mesh_lib.all_gather_rows(mesh, s.state),
                           alive=mesh_lib.all_gather_leaf(mesh, s.alive))
        out = swarm.gossip_round(full, torch.from_numpy(d["peers"]), gcounter.join)
        return out.state.counts.numpy()

    return _per_mesh(mesh4, mesh3, inputs, one)


# ---- the columnar sharded converges ----


def oplog_columnar(mesh4, mesh3, inputs):
    from crdt_tpu_torch import convert
    from crdt_tpu_torch.models import oplog_columnar as oc

    def one(mesh, d):
        col = oc.ColumnarOpLog(**{p: _shard(d[p], mesh, 1) for p in ("hi", "lo", "val", "pay")},
                               bits=tuple(d["bits"]))
        step = oc.sharded_converge(mesh, bits=d["bits"])
        out, nu = step(col, _shard(d["alive"], mesh))
        return convert.columnar_to_numpy(out), int(nu)

    return _per_mesh(mesh4, mesh3, inputs, one)


def rseq_columnar(mesh4, mesh3, inputs):
    from crdt_tpu_torch import convert
    from crdt_tpu_torch.models import rseq_columnar as rc

    def one(mesh, d):
        col = rc.ColumnarRSeq(keys=_shard(d["keys"], mesh, 2), elem=_shard(d["elem"], mesh, 1),
                              removed=_shard(d["removed"], mesh, 1), seq_bits=d["seq_bits"])
        step = rc.sharded_converge(mesh, depth=col.depth, seq_bits=d["seq_bits"])
        out, nu = step(col, _shard(d["alive"], mesh))
        return convert.columnar_rseq_to_numpy(out), int(nu)

    return _per_mesh(mesh4, mesh3, inputs, one)


def gc_columnar(mesh4, mesh3, inputs):
    from crdt_tpu_torch import convert
    from crdt_tpu_torch.models import rseq_columnar as rc, rseq_engine as re_

    def one(mesh, d):
        c = d["col"]
        cg = re_.ColumnarGc(
            col=rc.ColumnarRSeq(keys=_shard(c["keys"], mesh, 2), elem=_shard(c["elem"], mesh, 1),
                                removed=_shard(c["removed"], mesh, 1), seq_bits=c["seq_bits"]),
            floor=_shard(d["floor"], mesh, 1))
        step = re_.sharded_gc_converge(mesh, depth=cg.col.depth, seq_bits=c["seq_bits"])
        out, nu = step(cg, _shard(d["alive"], mesh))
        return convert.columnar_gc_to_numpy(out), int(nu)

    return _per_mesh(mesh4, mesh3, inputs, one)


def mismatched_steps(mesh4, mesh3, inputs):
    """The sharded steps refuse a state of another layout, on every rank."""
    from crdt_tpu_torch.models import oplog_columnar as oc, rseq_columnar as rc
    from crdt_tpu_torch.models import rseq_engine as re_

    errors = []
    col = oc.empty(8, 1, bits=(4, 22, 5), device="cpu")
    rcol = rc.empty(8, 1, depth=2, seq_bits=20, device="cpu")
    for step, state in ((oc.sharded_converge(mesh4), col),
                        (rc.sharded_converge(mesh4, depth=3), rcol),
                        (rc.sharded_converge(mesh4, depth=2, seq_bits=21), rcol),
                        (re_.sharded_gc_converge(mesh4, depth=2, seq_bits=21),
                         re_.ColumnarGc(col=rcol, floor=torch.full((2, 1), -1,
                                                                   dtype=torch.int32)))):
        try:
            step(state, torch.ones(1, dtype=torch.bool))
        except ValueError as e:
            errors.append(str(e))
    return errors


# ---- parallel.multihost (a world started by init_from_env) ----


def multihost_world(mesh4, mesh3, inputs):
    from crdt_tpu_torch import convert
    from crdt_tpu_torch.models import gcounter, oplog, oplog_columnar as oc
    from crdt_tpu_torch.parallel import mesh as mesh_lib, multihost, swarm

    m = multihost.global_mesh(device="cpu")
    again = multihost.init_from_env()
    counts = multihost.shard_host_local(
        gcounter.GCounter(counts=_shard(inputs["counts"], m)), m)
    pm = mesh_lib.pmax_converge(m)(swarm.make(counts)).state.counts.numpy()
    cap = inputs["cap"]
    logs = multihost.shard_host_local(
        oplog.OpLog(*(torch.full((2, cap), v, dtype=torch.int32) for v in
                      (2**31 - 1,) * 4 + (0, 0)), torch.zeros((2, cap), dtype=torch.bool)), m)
    gen = mesh_lib.sharded_converge(m, oplog.merge, oplog.merge,
                                    oplog.empty(cap, device="cpu"))(swarm.make(logs))
    col = oc.ColumnarOpLog(**{p: _shard(inputs["col"][p], m, 1) for p in ("hi", "lo", "val", "pay")},
                           bits=tuple(inputs["col"]["bits"]))
    out, nu = oc.sharded_converge(m, bits=col.bits)(
        col, torch.ones(col.lanes, dtype=torch.bool))
    return {"size": m.size, "rank": m.rank, "span": multihost.process_span(),
            "again": again, "backend": m.backend, "pmax": pm,
            "generic_size": int(oplog.size(gen.state).sum()),
            "columnar": convert.columnar_to_numpy(out), "nu": int(nu)}
