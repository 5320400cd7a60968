"""The port's join registry (crdt_tpu_torch.ops.joins, randstate, the
vv-clock lattice) against the JAX package's: the same 21 names, the same
seeded ``rand`` draws, joins, neutrals and seed domains, the same
``converge`` by name, and the lattice-law sweep of
tests/test_lattice_laws.py run over the torch registry.  Zero tolerance."""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.consistency import vvclock as jvv
from crdt_tpu.ops import joins as jjoins
from crdt_tpu_torch import convert
from crdt_tpu_torch.consistency import vvclock as tvv
from crdt_tpu_torch.ops import joins as tjoins
from crdt_tpu_torch.utils.tree import tree_map

N_REGISTRY_TRIALS = 12


def _np(x):
    """A JAX or port state as nested numpy (a dataclass by its fields)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (int, bool)):
        return x
    return np.asarray(x)


def assert_same(want, got):
    want, got = _np(want), _np(got)
    if isinstance(want, dict):
        assert want.keys() == got.keys()
        for k in want:
            assert_same(want[k], got[k])
    elif isinstance(want, int):
        assert want == got
    else:
        assert want.dtype == got.dtype, (want.dtype, got.dtype)
        np.testing.assert_array_equal(want, got)


def equal(x, y) -> bool:
    return all(torch.equal(a, b) for a, b in zip(_leaves(x), _leaves(y)))


def _leaves(x):
    from crdt_tpu_torch.utils.tree import leaves

    return leaves(x)


NAMES = sorted(jjoins.registered_joins())


def test_registry_has_jax_names_and_metadata():
    jr, tr = jjoins.registered_joins(), tjoins.registered_joins()
    assert sorted(tr) == NAMES and len(NAMES) == 21
    for name in NAMES:
        j, t = jr[name], tr[name]
        assert (t.parts, t.combinator, t.structurally_commutative) == (
            j.parts, j.combinator, j.structurally_commutative), name
        assert (t.small is None) == (j.small is None) and t.verified is None


@pytest.mark.parametrize("name", NAMES)
def test_rand_join_neutral_small_match_jax(name):
    """One seeded numpy rng a side: equal draws (the generators consume it
    in JAX's order), equal joins of the draws, equal neutral, equal seed
    domain and example operands."""
    j, t = jjoins.registered_joins()[name], tjoins.registered_joins()[name]
    rj, rt = np.random.default_rng(zlib.crc32(name.encode())), \
        np.random.default_rng(zlib.crc32(name.encode()))
    js = [j.rand(rj) for _ in range(4)]
    ts = [t.rand(rt, device="cpu") for _ in range(4)]
    for a, b in zip(js, ts):
        assert_same(a, b)
    for x, y in ((0, 1), (1, 0), (2, 3), (0, 0)):
        assert_same(j.join(js[x], js[y]), t.join(ts[x], ts[y]))
    assert_same(j.neutral(), t.neutral(device="cpu"))
    assert_same(j.join(js[2], j.neutral()), t.join(ts[2], t.neutral(device="cpu")))
    for a, b in zip(j.example(), t.example(device="cpu")):
        assert_same(a, b)
    if j.small is not None:
        sj, st = j.small(), t.small(device="cpu")
        assert len(sj) == len(st)
        for a, b in zip(sj, st):
            assert_same(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_registered_join_laws(name):
    """tests/test_lattice_laws.py's sweep over the torch registry: ACI and
    identity on states drawn by each spec's own generator."""
    spec = tjoins.registered_joins()[name]
    assert spec.rand is not None and spec.neutral is not None
    join = spec.join
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    neutral = spec.neutral(device="cpu")
    for _ in range(N_REGISTRY_TRIALS):
        a, b, c = (spec.rand(rng, device="cpu") for _ in range(3))
        assert equal(join(a, b), join(b, a)), "commutativity"
        assert equal(join(join(a, b), c), join(a, join(b, c))), "associativity"
        assert equal(join(a, a), a), "idempotence"
        assert equal(join(a, neutral), a), "identity"


def _stack_jax(states):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *states)


def _stack_torch(states):
    return tree_map(lambda *xs: torch.stack(xs), *states)


@pytest.mark.parametrize("name", NAMES)
def test_converge_by_name_matches_jax(name):
    """converge(name, stacked) on 5 replicas (padded to 8 with the
    registry's neutral) equals JAX's ``jax.vmap`` reduction — through the
    spec's own batched form, and through ``batched`` (torch.func.vmap)."""
    j, t = jjoins.registered_joins()[name], tjoins.registered_joins()[name]
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    js = [j.rand(rj) for _ in range(5)]
    ts = [t.rand(rt, device="cpu") for _ in range(5)]
    want = jjoins.converge(name, _stack_jax(js))
    assert_same(want, tjoins.converge(name, _stack_torch(ts)))
    assert_same(want, tjoins.converge(t, _stack_torch(ts)))
    assert_same(want, tjoins.converge(tjoins.batched(t.join), _stack_torch(ts),
                                      t.neutral(device="cpu")))


def test_registry_driven_converge_forms():
    """tests/test_lattice_laws.py's test_registry_driven_converge: name,
    spec and explicit forms agree; a bare callable needs a neutral; an
    unknown name raises."""
    from crdt_tpu_torch.models import pncounter

    spec = tjoins.registered_joins()["pncounter"]
    rng = np.random.default_rng(5)
    stacked = _stack_torch([spec.rand(rng, device="cpu") for _ in range(5)])
    by_name = tjoins.converge("pncounter", stacked)
    assert equal(by_name, tjoins.converge(spec, stacked))
    assert equal(by_name, tjoins.converge(tjoins.batched(pncounter.join), stacked,
                                          pncounter.zero(8, device="cpu")))
    with pytest.raises(ValueError):
        tjoins.tree_reduce_join(tjoins.batched(pncounter.join), stacked)
    with pytest.raises(KeyError):
        tjoins.tree_reduce_join("no_such_join", stacked)


def test_donating_is_the_join_itself():
    """torch has no buffer donation: ``donating`` returns the join, whose
    results equal the plain join's, and the operands stay usable."""
    spec = tjoins.registered_joins()["orset"]
    rng = np.random.default_rng(3)
    a, b = spec.rand(rng, device="cpu"), spec.rand(rng, device="cpu")
    fn = tjoins.donating(spec.join)
    assert fn is spec.join
    assert equal(fn(a, b), spec.join(a, b)) and equal(fn(a, b), fn(a, b))


def test_register_join_needs_example_or_neutral():
    with pytest.raises(ValueError):
        tjoins.register_join("no_neutral_join", lambda a, b: a)
    assert "no_neutral_join" not in tjoins.registered_joins()


@pytest.mark.parametrize("writer", [0, 3, -1, -8, 8, -9])
def test_vvclock_ops_match_jax(writer):
    """zero, advance (JAX's ``.at[]`` index rules: a negative writer wraps
    once, out of range changes nothing), join, meet, dominates, ops_known,
    on batched clocks; and the convert carrier."""
    rng = np.random.default_rng(11)
    a_np = rng.integers(-1, 20, (3, 8)).astype(np.int32)
    b_np = rng.integers(-1, 20, (3, 8)).astype(np.int32)
    ja, jb = jvv.VVClock(seqs=jnp.asarray(a_np)), jvv.VVClock(seqs=jnp.asarray(b_np))
    ta = convert.vvclock_from_numpy({"seqs": a_np}, device="cpu")
    tb = convert.vvclock_from_numpy({"seqs": b_np}, device="cpu")
    assert_same(jvv.zero(8, (2,)), tvv.zero(8, (2,), device="cpu"))
    for seq in (7, 25):
        assert_same(jvv.advance(ja, writer, seq), tvv.advance(ta, writer, seq))
    assert_same(jvv.join(ja, jb), tvv.join(ta, tb))
    assert_same(jvv.meet(ja, jb), tvv.meet(ta, tb))
    j = jvv.join(ja, jb)
    t = tvv.join(ta, tb)
    assert_same(jvv.dominates(j, ja), tvv.dominates(t, ta))
    assert_same(jvv.dominates(ja, jb), tvv.dominates(ta, tb))
    assert_same(jvv.ops_known(ja), tvv.ops_known(ta))
    np.testing.assert_array_equal(convert.vvclock_to_numpy(t)["seqs"], np.asarray(j.seqs))
