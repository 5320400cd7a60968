"""Small reachable-state domains for exhaustive lattice-law checking
(counterpart of ``crdt_tpu.analysis.verify.domains``).

A *domain* is a finite list of states (all at the registered layout) the
prover checks laws over.  The lattice laws are pure equations, so
checking them over ANY subset of reachable states is sound; closure
under the join matters for *diversity* (joined states exercise branches
independent draws miss) and for the ``closed`` flag: a domain closed
under the join is a sub-semilattice, and a law proved over all of it is
proved for that whole sub-algebra, which is what upgrades the verdict
from sampled to ``proved``.

Seed policy (ops/randstate.py has the soundness rules):

* ``spec.small()`` when registered: deterministic tiny enumerations;
* otherwise fixed-seed ``spec.rand`` draws, the seed derived from the
  join's name exactly as the JAX package derives it, so the domain (and
  the committed ledger) is reproducible and equals JAX's.

States are built on ``device`` (None: the CUDA card); content keys are
taken on the host, one transfer a closure round.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, List

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.ops import joins
from crdt_tpu_torch.utils.tree import leaves, tree_map

#: default domain size cap: closure stops (and the domain is marked
#: unclosed) once this many states accumulate; 36**3 ≈ 47k triple joins
#: is the worst associativity sweep
DEFAULT_CAP = 36

#: rand draws for joins with no ``small`` enumerator: the join-closure of
#: m generators has at most 2^m - 1 states, so 5 seeds + neutral close
#: within DEFAULT_CAP and the verdict can reach ``proved``
DEFAULT_SEEDS = 5


@dataclasses.dataclass
class Domain:
    """The prover's finite state domain for one join."""

    states: List[Any]
    closed: bool  # True iff the list is closed under the join
    source: str  # "small" | "rand" | "neutral-only"
    rounds: int  # closure rounds run


def _leaf_key(h, arr: np.ndarray) -> None:
    h.update(str(arr.shape).encode())
    h.update(str(arr.dtype).encode())
    h.update(np.ascontiguousarray(arr).tobytes())


def state_key(state) -> bytes:
    """Content key for deduplication: leaf bytes + shapes + dtypes."""
    h = hashlib.sha1()
    for leaf in leaves(state):
        _leaf_key(h, leaf.detach().cpu().numpy())
    return h.digest()


def row_keys(stacked, rows: int) -> List[bytes]:
    """:func:`state_key` of every row of a stacked state, from one host
    copy of each leaf."""
    host = [leaf.detach().cpu().numpy() for leaf in leaves(stacked)]
    out = []
    for r in range(rows):
        h = hashlib.sha1()
        for arr in host:
            _leaf_key(h, arr[r])
        out.append(h.digest())
    return out


def stack(states: List[Any]):
    """Stack a state list into one state with a leading domain axis."""
    return tree_map(lambda *xs: torch.stack(xs), *states)


def unstack_row(stacked, i: int):
    return tree_map(lambda x: x[i], stacked)


def gather(stacked, idx):
    """Rows ``idx`` (a numpy index array) of a stacked state."""
    index = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                            device=leaves(stacked)[0].device)
    return tree_map(lambda x: x[index], stacked)


def batched_join(spec):
    """The join over stacked states the sweeps use: the spec's own
    ``batched`` where registered (a kernel that takes the replicas as
    lanes), else ``joins.batched`` of the single-instance join."""
    return spec.batched or joins.batched(spec.join)


def _name_seed(name: str) -> int:
    return int.from_bytes(hashlib.sha1(name.encode()).digest()[:4], "big")


def seed_states(spec, n_seeds: int = DEFAULT_SEEDS, device=None) -> Domain:
    """The pre-closure seed list: neutral + small enumeration (or
    fixed-seed rand draws), deduplicated in order."""
    device = default_device(device)
    states: List[Any] = []
    if spec.neutral is not None:
        states.append(spec.neutral(device=device))
    if spec.small is not None:
        states.extend(spec.small(device=device))
        source = "small"
    elif spec.rand is not None:
        rng = np.random.default_rng(_name_seed(spec.name))
        states.extend(spec.rand(rng, device=device) for _ in range(n_seeds))
        source = "rand"
    else:
        source = "neutral-only"
    seen = set()
    uniq = []
    for s in states:
        k = state_key(s)
        if k not in seen:
            seen.add(k)
            uniq.append(s)
    return Domain(states=uniq, closed=False, source=source, rounds=0)


def _all_pairs(vjoin, states):
    n = len(states)
    stacked = stack(states)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return vjoin(gather(stacked, ii.ravel()), gather(stacked, jj.ravel())), n * n


def build_domain(spec, cap: int = DEFAULT_CAP, n_seeds: int = DEFAULT_SEEDS,
                 device=None) -> Domain:
    """Seed, then close under the join until fixpoint or ``cap``.

    Closure is all-pairs per round: new states join the domain until a
    round adds nothing (``closed=True``) or the cap is hit
    (``closed=False``, and the verdict then degrades to ``assumed``)."""
    dom = seed_states(spec, n_seeds, device)
    if not dom.states:
        return dom
    vjoin = batched_join(spec)
    seen = {state_key(s) for s in dom.states}
    while len(dom.states) < cap:
        dom.rounds += 1
        joined, rows = _all_pairs(vjoin, dom.states)
        fresh = []
        for r, k in enumerate(row_keys(joined, rows)):
            if k not in seen:
                seen.add(k)
                fresh.append(unstack_row(joined, r))
                if len(dom.states) + len(fresh) >= cap:
                    break
        if not fresh:
            dom.closed = True
            return dom
        dom.states.extend(fresh)
    # cap hit: one more all-pairs pass may or may not close; report honestly
    joined, rows = _all_pairs(vjoin, dom.states)
    dom.closed = all(k in seen for k in row_keys(joined, rows))
    return dom
