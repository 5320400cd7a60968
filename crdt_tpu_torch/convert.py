"""State carried across from the JAX package, as numpy.

The JAX package's ``OpLog`` and ``ColumnarOpLog`` are plain arrays; these
functions take them as a dict of numpy arrays (``np.asarray`` of each
field) and build the port's tensors, and give them back the same way, so
both packages can be fed identical state and compared plane by plane.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models.oplog import _FIELDS, KVState, OpLog
from crdt_tpu_torch.models.oplog_columnar import ColumnarOpLog

_COLUMNAR_PLANES = ("hi", "lo", "val", "pay")
_KV_FIELDS = ("present", "is_num", "num", "num_count", "payload")


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x)).to(device=device, dtype=dtype)


def oplog_from_numpy(d: Mapping[str, np.ndarray], device=None) -> OpLog:
    """An OpLog (single or batched) from its seven fields as numpy arrays."""
    device = default_device(device)
    return OpLog(**{
        f: _tensor(d[f], torch.bool if f == "is_num" else torch.int32, device)
        for f in _FIELDS
    })


def oplog_to_numpy(log: OpLog) -> dict:
    return {f: getattr(log, f).cpu().numpy() for f in _FIELDS}


def columnar_from_numpy(d: Mapping[str, np.ndarray], bits, device=None) -> ColumnarOpLog:
    """A ColumnarOpLog from its four (C, R) planes as numpy arrays plus the
    pack split ``bits``."""
    device = default_device(device)
    return ColumnarOpLog(
        **{p: _tensor(d[p], torch.int32, device) for p in _COLUMNAR_PLANES},
        bits=tuple(bits),
    )


def columnar_to_numpy(col: ColumnarOpLog) -> dict:
    out = {p: getattr(col, p).cpu().numpy() for p in _COLUMNAR_PLANES}
    out["bits"] = tuple(col.bits)
    return out


def kvstate_to_numpy(kv: KVState) -> dict:
    return {f: getattr(kv, f).cpu().numpy() for f in _KV_FIELDS}
