"""EW-Flag / DW-Flag: observed-token boolean lattices as tensors
(counterpart of ``crdt_tpu.models.flags``).

``TokenPlane`` (writer universe W):

* ``tok: int32[..., W]``    — per writer, the seq of its latest token (-1 =
  none);
* ``obs: int32[..., W, W]`` — ``obs[w, j]`` = the token seq of writer j seen
  at writer w's latest clear.

A plane is active when some token is unobserved by every clear.  A token
bumps the writer's ``tok`` slot; a clear copies the held ``tok`` vector
into the writer's ``obs`` row; join = elementwise max of both fields.
Writer indices follow JAX's ``.at[]`` rules (negative counts from the end
once, out of range changes nothing).

* EWFlag — tokens are enables, disables clear: a concurrent enable wins.
* DWFlag — tokens are disables, enables clear, plus a monotone ``touched``
  bit so the initial state reads False: a concurrent disable wins.
"""
from __future__ import annotations

import dataclasses

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models.gcounter import add_at
from crdt_tpu_torch.models.oplog import at_slot


@dataclasses.dataclass
class TokenPlane:
    tok: torch.Tensor  # int32[..., W]
    obs: torch.Tensor  # int32[..., W, W]

    @property
    def n_writers(self) -> int:
        return self.tok.shape[-1]


def plane_zero(n_writers: int, batch: tuple = (), device=None) -> TokenPlane:
    device = default_device(device)
    return TokenPlane(
        tok=torch.full((*batch, n_writers), -1, dtype=torch.int32, device=device),
        obs=torch.full((*batch, n_writers, n_writers), -1, dtype=torch.int32, device=device),
    )


def plane_token(p: TokenPlane, writer) -> TokenPlane:
    return TokenPlane(tok=add_at(p.tok, writer, 1), obs=p.obs)


def plane_clear(p: TokenPlane, writer) -> TokenPlane:
    obs = p.obs.clone()
    slot = at_slot(writer, p.n_writers)
    if slot is not None:
        obs[..., slot, :] = p.tok
    return TokenPlane(tok=p.tok, obs=obs)


def plane_join(a: TokenPlane, b: TokenPlane) -> TokenPlane:
    return TokenPlane(tok=torch.maximum(a.tok, b.tok), obs=torch.maximum(a.obs, b.obs))


def plane_active(p: TokenPlane) -> torch.Tensor:
    """bool[...]: does an unobserved (never-cleared) token exist?"""
    seen = p.obs.amax(dim=-2)  # the best clear per token writer
    return ((p.tok >= 0) & (p.tok > seen)).any(dim=-1)


# ---- EW-Flag: enable-wins ----


@dataclasses.dataclass
class EWFlag:
    plane: TokenPlane  # tokens = enables


def ew_zero(n_writers: int, batch: tuple = (), device=None) -> EWFlag:
    return EWFlag(plane=plane_zero(n_writers, batch, device=device))


def ew_enable(f: EWFlag, writer) -> EWFlag:
    return EWFlag(plane=plane_token(f.plane, writer))


def ew_disable(f: EWFlag, writer) -> EWFlag:
    """Disable clears only *observed* enables: a concurrent enable wins."""
    return EWFlag(plane=plane_clear(f.plane, writer))


def ew_join(a: EWFlag, b: EWFlag) -> EWFlag:
    return EWFlag(plane=plane_join(a.plane, b.plane))


def ew_value(f: EWFlag) -> torch.Tensor:
    return plane_active(f.plane)


# ---- DW-Flag: disable-wins ----


@dataclasses.dataclass
class DWFlag:
    plane: TokenPlane      # tokens = disables
    touched: torch.Tensor  # bool[...]: ever enabled (monotone OR)


def dw_zero(n_writers: int, batch: tuple = (), device=None) -> DWFlag:
    device = default_device(device)
    return DWFlag(plane=plane_zero(n_writers, batch, device=device),
                  touched=torch.zeros(batch, dtype=torch.bool, device=device))


def dw_enable(f: DWFlag, writer) -> DWFlag:
    """Enable clears only *observed* disables: a concurrent disable wins.
    ``touched`` becomes all ones, whatever the writer."""
    return DWFlag(plane=plane_clear(f.plane, writer), touched=torch.ones_like(f.touched))


def dw_disable(f: DWFlag, writer) -> DWFlag:
    return DWFlag(plane=plane_token(f.plane, writer), touched=f.touched)


def dw_join(a: DWFlag, b: DWFlag) -> DWFlag:
    return DWFlag(plane=plane_join(a.plane, b.plane), touched=a.touched | b.touched)


def dw_value(f: DWFlag) -> torch.Tensor:
    return f.touched & ~plane_active(f.plane)
