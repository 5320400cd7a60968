"""MV-Register: multi-value register lattice as tensors (counterpart of
``crdt_tpu.models.mvregister``).

For a writer universe of size W, one register is:

* ``seq: int32[..., W]``           — per writer, the seq of its latest
  write (-1 = never wrote);
* ``ts, payload: int32[..., W]``   — that write's timestamp and interned
  value id;
* ``obs: int32[..., W, W]``        — ``obs[w, j]`` = the seq of writer j's
  write that writer w had seen when it made its latest write.

A write by w is visible (a current sibling) iff no held write covers it:
``all_j obs[j, w] < seq[w]``.  The join is a per-writer newest-wins select;
on equal seqs it takes the elementwise max of ts, payload and obs, so the
laws hold on every state.  Writer indices follow JAX's ``.at[]`` rules
(negative counts from the end once, out of range changes nothing).
"""
from __future__ import annotations

import dataclasses

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models.gcounter import add_at
from crdt_tpu_torch.models.oplog import at_slot


@dataclasses.dataclass
class MVRegister:
    seq: torch.Tensor      # int32[..., W]
    ts: torch.Tensor       # int32[..., W]
    payload: torch.Tensor  # int32[..., W]
    obs: torch.Tensor      # int32[..., W, W]

    @property
    def n_writers(self) -> int:
        return self.seq.shape[-1]


def zero(n_writers: int, batch: tuple = (), device=None) -> MVRegister:
    device = default_device(device)
    shape = (*batch, n_writers)
    return MVRegister(
        seq=torch.full(shape, -1, dtype=torch.int32, device=device),
        ts=torch.zeros(shape, dtype=torch.int32, device=device),
        payload=torch.zeros(shape, dtype=torch.int32, device=device),
        obs=torch.full((*shape, n_writers), -1, dtype=torch.int32, device=device),
    )


def write(reg: MVRegister, writer, ts, payload) -> MVRegister:
    """Local op: ``writer`` overwrites the register, covering every write
    the register holds (they stop being visible); concurrent writes it has
    not seen survive as siblings."""
    slot = at_slot(writer, reg.n_writers)
    ts_plane, pay_plane, obs = reg.ts.clone(), reg.payload.clone(), reg.obs.clone()
    if slot is not None:
        ts_plane[..., slot] = torch.as_tensor(ts, dtype=torch.int32, device=reg.ts.device)
        pay_plane[..., slot] = torch.as_tensor(payload, dtype=torch.int32,
                                               device=reg.ts.device)
        obs[..., slot, :] = reg.seq  # the causal context: everything held
    return MVRegister(seq=add_at(reg.seq, writer, 1), ts=ts_plane, payload=pay_plane,
                      obs=obs)


def join(a: MVRegister, b: MVRegister) -> MVRegister:
    """Per-writer newest-wins select (ties: elementwise max)."""
    b_newer = b.seq > a.seq
    tie = b.seq == a.seq

    def pick(x, y, newer, same):
        return torch.where(newer, y, torch.where(same, torch.maximum(x, y), x))

    return MVRegister(
        seq=torch.maximum(a.seq, b.seq),
        ts=pick(a.ts, b.ts, b_newer, tie),
        payload=pick(a.payload, b.payload, b_newer, tie),
        obs=pick(a.obs, b.obs, b_newer[..., None], tie[..., None]),
    )


def visible(reg: MVRegister) -> torch.Tensor:
    """bool[..., W]: which writers' latest writes are current siblings
    (written, and covered by no held write's context; a writer's own row
    never covers its newest write, recorded before the bump)."""
    covered = (reg.obs >= reg.seq[..., None, :]).any(dim=-2)
    return (reg.seq >= 0) & ~covered


def values(reg: MVRegister) -> tuple:
    """(mask, payload): the sibling set — the payloads of visible writers."""
    return visible(reg), reg.payload


def n_siblings(reg: MVRegister) -> torch.Tensor:
    return visible(reg).sum(dim=-1, dtype=torch.int32)
