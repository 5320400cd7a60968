"""State carried across from the JAX package, as numpy.

The JAX package's ``OpLog``, ``CompactedLog``, ``ColumnarOpLog``,
``ORSet``, ``ORSetBitmap``, ``ORSetBucketed``, ``RSeq``, ``ColumnarRSeq``,
``Gc``, ``ColumnarGc``, the counters (``GCounter``, ``PNCounter``), the
registers and flags (``LWWRegister``, ``PackedLWW``, ``TokenPlane``,
``EWFlag``, ``DWFlag``, ``MVRegister``), the watermark ``VVClock`` and the
composites (``ORMap``, ``MapGc`` and ``Pair``, generic over their parts)
are plain arrays; these functions
take them as a dict of numpy arrays (``np.asarray`` of each field) and
build the port's tensors, and give them back the same way, so both
packages can be fed identical state and compared plane by plane.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.consistency.vvclock import VVClock
from crdt_tpu_torch.models.compactlog import SUMMARY_FIELDS, CompactedLog, Summary
from crdt_tpu_torch.models.composite import Pair
from crdt_tpu_torch.models.flags import DWFlag, EWFlag, TokenPlane
from crdt_tpu_torch.models.gcounter import GCounter
from crdt_tpu_torch.models.lww import LWWRegister, PackedLWW
from crdt_tpu_torch.models.mvregister import MVRegister
from crdt_tpu_torch.models.oplog import _FIELDS, KVState, OpLog
from crdt_tpu_torch.models.oplog_columnar import ColumnarOpLog
from crdt_tpu_torch.models.ormap import ORMap
from crdt_tpu_torch.models.ormap_gc import MapGc
from crdt_tpu_torch.models.orset import ORSet, ORSetBitmap, ORSetBucketed
from crdt_tpu_torch.models.pncounter import PNCounter
from crdt_tpu_torch.models.rseq import RSeq
from crdt_tpu_torch.models.rseq_columnar import ColumnarRSeq
from crdt_tpu_torch.models.rseq_engine import ColumnarGc
from crdt_tpu_torch.models.tomb_gc import Gc

_COLUMNAR_PLANES = ("hi", "lo", "val", "pay")
_KV_FIELDS = ("present", "is_num", "num", "num_count", "payload")
_ORSET_FIELDS = ("elem", "rid", "seq", "removed")


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


def compactlog_from_numpy(d: Mapping, device=None) -> CompactedLog:
    """A CompactedLog from ``{"summary": {field: array}, "frontier": array,
    "tail": {field: array}}`` (the tail as :func:`oplog_from_numpy` takes
    it)."""
    device = default_device(device)
    summary = Summary(**{
        f: _tensor(d["summary"][f], torch.bool if f in ("present", "is_num")
                   else torch.int32, device)
        for f in SUMMARY_FIELDS
    })
    return CompactedLog(summary=summary,
                        frontier=_tensor(d["frontier"], torch.int32, device),
                        tail=oplog_from_numpy(d["tail"], device=device))


def compactlog_to_numpy(c: CompactedLog) -> dict:
    return {"summary": {f: getattr(c.summary, f).cpu().numpy() for f in SUMMARY_FIELDS},
            "frontier": c.frontier.cpu().numpy(), "tail": oplog_to_numpy(c.tail)}


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


def orset_from_numpy(d: Mapping[str, np.ndarray], device=None) -> ORSet:
    """An ORSet (single [C] or batched [R, C]) from elem/rid/seq/removed."""
    device = default_device(device)
    return ORSet(**{
        f: _tensor(d[f], torch.bool if f == "removed" else torch.int32, device)
        for f in _ORSET_FIELDS
    })


def orset_to_numpy(s: ORSet) -> dict:
    return {f: getattr(s, f).cpu().numpy() for f in _ORSET_FIELDS}


def bitmap_from_numpy(d: Mapping[str, np.ndarray], device=None) -> ORSetBitmap:
    """An ORSetBitmap from its present/removed int32 word planes."""
    device = default_device(device)
    return ORSetBitmap(present=_tensor(d["present"], torch.int32, device),
                       removed=_tensor(d["removed"], torch.int32, device))


def bitmap_to_numpy(s: ORSetBitmap) -> dict:
    return {"present": s.present.cpu().numpy(), "removed": s.removed.cpu().numpy()}


def bucketed_from_numpy(d: Mapping[str, np.ndarray], n_buckets: int,
                        key_bits: int = 31, device=None) -> ORSetBucketed:
    """An ORSetBucketed from its keys/removed planes plus the layout's
    static bucket count and key width."""
    device = default_device(device)
    return ORSetBucketed(keys=_tensor(d["keys"], torch.int32, device),
                         removed=_tensor(d["removed"], torch.int32, device),
                         n_buckets=n_buckets, key_bits=key_bits)


def bucketed_to_numpy(s: ORSetBucketed) -> dict:
    return {"keys": s.keys.cpu().numpy(), "removed": s.removed.cpu().numpy(),
            "n_buckets": s.n_buckets, "key_bits": s.key_bits}


def rseq_from_numpy(d: Mapping[str, np.ndarray], device=None) -> RSeq:
    """An RSeq (single [C, 4D] or batched [R, C, 4D]) from keys/elem/removed."""
    device = default_device(device)
    return RSeq(keys=_tensor(d["keys"], torch.int32, device),
                elem=_tensor(d["elem"], torch.int32, device),
                removed=_tensor(d["removed"], torch.bool, device))


def rseq_to_numpy(s: RSeq) -> dict:
    return {f: getattr(s, f).cpu().numpy() for f in ("keys", "elem", "removed")}


def columnar_rseq_from_numpy(d: Mapping[str, np.ndarray], seq_bits: int,
                             device=None) -> ColumnarRSeq:
    """A ColumnarRSeq from its keys (3D, C, R), elem and removed (C, R)
    planes plus the identity word's ``seq_bits``."""
    device = default_device(device)
    return ColumnarRSeq(**{f: _tensor(d[f], torch.int32, device)
                           for f in ("keys", "elem", "removed")},
                        seq_bits=int(seq_bits))


def columnar_rseq_to_numpy(col: ColumnarRSeq) -> dict:
    out = {f: getattr(col, f).cpu().numpy() for f in ("keys", "elem", "removed")}
    out["seq_bits"] = col.seq_bits
    return out


def gc_from_numpy(d: Mapping[str, np.ndarray], inner_from_numpy, device=None) -> Gc:
    """A Gc from ``{"inner": <inner's dict>, "floor": int32[..., W]}``;
    ``inner_from_numpy`` builds the wrapped state (``rseq_from_numpy``,
    ``orset_from_numpy``)."""
    device = default_device(device)
    return Gc(inner=inner_from_numpy(d["inner"], device=device),
              floor=_tensor(d["floor"], torch.int32, device))


def gc_to_numpy(g: Gc, inner_to_numpy) -> dict:
    return {"inner": inner_to_numpy(g.inner), "floor": g.floor.cpu().numpy()}


def columnar_gc_from_numpy(d: Mapping[str, np.ndarray], device=None) -> ColumnarGc:
    """A ColumnarGc from ``{"col": <columnar_rseq dict with seq_bits>,
    "floor": int32[W, R]}``."""
    device = default_device(device)
    return ColumnarGc(col=columnar_rseq_from_numpy(d["col"], d["col"]["seq_bits"],
                                                   device=device),
                      floor=_tensor(d["floor"], torch.int32, device))


def columnar_gc_to_numpy(cg: ColumnarGc) -> dict:
    return {"col": columnar_rseq_to_numpy(cg.col), "floor": cg.floor.cpu().numpy()}


# ---- counters, registers and flags ----


def _planes_from(cls, d, fields, device, **static):
    device = default_device(device)
    return cls(**{f: _tensor(d[f], torch.int32, device) for f in fields}, **static)


def _planes_to(x, fields) -> dict:
    return {f: getattr(x, f).cpu().numpy() for f in fields}


def gcounter_from_numpy(d: Mapping[str, np.ndarray], device=None) -> GCounter:
    """A GCounter from its ``counts`` plane."""
    return _planes_from(GCounter, d, ("counts",), device)


def gcounter_to_numpy(c: GCounter) -> dict:
    return _planes_to(c, ("counts",))


def pncounter_from_numpy(d: Mapping[str, np.ndarray], device=None) -> PNCounter:
    """A PNCounter from its ``pos``/``neg`` planes."""
    return _planes_from(PNCounter, d, ("pos", "neg"), device)


def pncounter_to_numpy(c: PNCounter) -> dict:
    return _planes_to(c, ("pos", "neg"))


def lww_from_numpy(d: Mapping[str, np.ndarray], device=None) -> LWWRegister:
    """An LWWRegister from its ``ts``/``rid``/``payload`` planes."""
    return _planes_from(LWWRegister, d, ("ts", "rid", "payload"), device)


def lww_to_numpy(r: LWWRegister) -> dict:
    return _planes_to(r, ("ts", "rid", "payload"))


def packed_lww_from_numpy(d: Mapping[str, np.ndarray], device=None) -> PackedLWW:
    """A PackedLWW from its ``key``/``payload`` planes plus the static
    ``rid_bits``."""
    return _planes_from(PackedLWW, d, ("key", "payload"), device, rid_bits=int(d["rid_bits"]))


def packed_lww_to_numpy(p: PackedLWW) -> dict:
    return {**_planes_to(p, ("key", "payload")), "rid_bits": p.rid_bits}


def token_plane_from_numpy(d: Mapping[str, np.ndarray], device=None) -> TokenPlane:
    """A TokenPlane from its ``tok``/``obs`` planes."""
    return _planes_from(TokenPlane, d, ("tok", "obs"), device)


def token_plane_to_numpy(p: TokenPlane) -> dict:
    return _planes_to(p, ("tok", "obs"))


def ewflag_from_numpy(d: Mapping[str, np.ndarray], device=None) -> EWFlag:
    """An EWFlag from ``{"plane": <token plane dict>}``."""
    return EWFlag(plane=token_plane_from_numpy(d["plane"], device=device))


def ewflag_to_numpy(f: EWFlag) -> dict:
    return {"plane": token_plane_to_numpy(f.plane)}


def dwflag_from_numpy(d: Mapping[str, np.ndarray], device=None) -> DWFlag:
    """A DWFlag from ``{"plane": <token plane dict>, "touched": bool[...]}``."""
    device = default_device(device)
    return DWFlag(plane=token_plane_from_numpy(d["plane"], device=device),
                  touched=_tensor(d["touched"], torch.bool, device))


def dwflag_to_numpy(f: DWFlag) -> dict:
    return {"plane": token_plane_to_numpy(f.plane), "touched": f.touched.cpu().numpy()}


def mvregister_from_numpy(d: Mapping[str, np.ndarray], device=None) -> MVRegister:
    """An MVRegister from its ``seq``/``ts``/``payload``/``obs`` planes."""
    return _planes_from(MVRegister, d, ("seq", "ts", "payload", "obs"), device)


def mvregister_to_numpy(r: MVRegister) -> dict:
    return _planes_to(r, ("seq", "ts", "payload", "obs"))


# ---- the watermark lattice and the composites ----


def vvclock_from_numpy(d: Mapping[str, np.ndarray], device=None):
    """A VVClock from its ``seqs`` plane."""
    return _planes_from(VVClock, d, ("seqs",), device)


def vvclock_to_numpy(c) -> dict:
    return _planes_to(c, ("seqs",))


def ormap_from_numpy(d: Mapping, values_from_numpy, device=None):
    """An ORMap from ``{"presence": <token plane dict>, "values": <the value
    lattice's dict>}``; ``values_from_numpy`` builds the value planes
    (``pncounter_from_numpy``, ``lww_from_numpy``, ...)."""
    return ORMap(presence=token_plane_from_numpy(d["presence"], device=device),
                 values=values_from_numpy(d["values"], device=device))


def ormap_to_numpy(m, values_to_numpy) -> dict:
    return {"presence": token_plane_to_numpy(m.presence),
            "values": values_to_numpy(m.values)}


def mapgc_from_numpy(d: Mapping, values_from_numpy, device=None):
    """A MapGc from ``{"map": <ormap dict>, "epoch": int32[K]}``."""
    device = default_device(device)
    return MapGc(map=ormap_from_numpy(d["map"], values_from_numpy, device=device),
                 epoch=_tensor(d["epoch"], torch.int32, device))


def mapgc_to_numpy(g, values_to_numpy) -> dict:
    return {"map": ormap_to_numpy(g.map, values_to_numpy), "epoch": g.epoch.cpu().numpy()}


def pair_from_numpy(d: Mapping, fst_from_numpy, snd_from_numpy, device=None):
    """A composite Pair from ``{"fst": <part dict>, "snd": <part dict>}``."""
    return Pair(fst=fst_from_numpy(d["fst"], device=device),
                snd=snd_from_numpy(d["snd"], device=device))


def pair_to_numpy(p, fst_to_numpy, snd_to_numpy) -> dict:
    return {"fst": fst_to_numpy(p.fst), "snd": snd_to_numpy(p.snd)}
