"""Columnar op-page wire format: the ingest front door's batch encoding
(own copy of ``crdt_tpu.ingest.wire``; the bytes are the same).

One page carries N single-key write ops from ONE origin (a client writer
stream) as fixed-width little-endian planes:

    offset  size          field
    ------  ------------  ------------------------------------------
    0       8             magic  b"CRDTPAGE"
    8       u16           version (== 1)
    10      u16           flags (reserved, must be 0)
    12      i32           origin      client writer-stream id (>= 0)
    16      u32           page_seq    per-origin page counter (admission
                                      ordering + duplicate-retry dedup)
    20      u32           n_ops
    24      u32           key-table byte length   (Kb)
    28      u32           value-table byte length (Vb)
    32      u32           crc32 of everything after the header
    36      u32[n_ops]    seq plane: per-origin op sequence, strictly
                          increasing within the page
    ...     i32[n_ops]    wire-ts plane: mint timestamp in the node's
                          relative-ms domain, window [0, 2^31-1);
                          WIRE_TS_NOW (-1) = "stamp at admission"
    ...     u32[n_ops]    key-id plane: index into the key table
    ...     u32[n_ops]    value-id plane: index into the value table
    ...     key table     u32 count, u32[count] end-offsets, UTF-8 bytes
    ...     value table   u32 count, u32[count] end-offsets, UTF-8 bytes

Decode validates everything before a single op is admitted: magic,
version, flags, every declared length against the byte count, the
checksum, seq monotonicity, the ts window and every key/value id against
its table.  Any violation raises :class:`PageFormatError` and the caller
quarantines the page whole (HTTP 400): a truncated page is always "no
page", never "some ops".
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"CRDTPAGE"
VERSION = 1
_HEADER = struct.Struct("<8sHHiIIIII")  # magic ver flags origin pseq n kb vb crc
HEADER_SIZE = _HEADER.size

INT32_MAX = 2**31 - 1
#: wire-ts sentinel: "no client timestamp — stamp with the admitting
#: node's clock at drain time"
WIRE_TS_NOW = -1

#: hard cap on ops per page: bounds decode-time allocation from an
#: attacker-controlled n_ops before any plane is touched
MAX_OPS_PER_PAGE = 65536
#: hard cap on either string table's byte length
MAX_TABLE_BYTES = 1 << 24


class PageFormatError(ValueError):
    """Raised by decode_page for ANY malformed page: the page is
    quarantined whole; no prefix of its ops is ever admitted."""


@dataclass
class OpPage:
    """A decoded (validated) op page."""
    origin: int
    page_seq: int
    seq: np.ndarray       # u32[n] strictly increasing
    wire_ts: np.ndarray   # i32[n] each WIRE_TS_NOW or in [0, 2^31-1)
    key_id: np.ndarray    # u32[n] -> keys
    val_id: np.ndarray    # u32[n] -> values
    keys: List[str]
    values: List[str]

    @property
    def n_ops(self) -> int:
        return int(self.seq.shape[0])

    def rows(self) -> List[Tuple[Optional[int], Dict[str, str]]]:
        """Materialize (ts, {key: value}) admission rows; ts is None for
        WIRE_TS_NOW ops (the drain stamps them).  One bulk tolist() a
        plane.  The command dicts are SHARED per distinct (key_id, val_id)
        pair and must be treated as immutable: a page over a 16-key
        alphabet allocates ~16 dicts, not n_ops."""
        keys, values = self.keys, self.values
        nv = len(values)
        cache: Dict[int, Dict[str, str]] = {}
        out: List[Tuple[Optional[int], Dict[str, str]]] = []
        for ts, k, v in zip(self.wire_ts.tolist(), self.key_id.tolist(),
                            self.val_id.tolist()):
            pair = k * nv + v
            cmd = cache.get(pair)
            if cmd is None:
                cmd = cache[pair] = {keys[k]: values[v]}
            out.append((None if ts == WIRE_TS_NOW else ts, cmd))
        return out


def _encode_table(strings: List[str]) -> bytes:
    blobs = [s.encode("utf-8") for s in strings]
    ends, total = [], 0
    for b in blobs:
        total += len(b)
        ends.append(total)
    return (struct.pack("<I", len(blobs))
            + np.asarray(ends, np.uint32).tobytes()
            + b"".join(blobs))


def _decode_table(buf: bytes, what: str) -> List[str]:
    if len(buf) < 4:
        raise PageFormatError(f"{what} table truncated (no count)")
    (count,) = struct.unpack_from("<I", buf, 0)
    if count > MAX_TABLE_BYTES // 4:
        raise PageFormatError(f"{what} table count {count} over cap")
    need = 4 + 4 * count
    if len(buf) < need:
        raise PageFormatError(f"{what} table truncated (offsets)")
    ends = np.frombuffer(buf, np.uint32, count, offset=4)
    data = buf[need:]
    if count and (np.any(np.diff(ends.astype(np.int64)) < 0)
                  or int(ends[-1]) != len(data)):
        raise PageFormatError(
            f"{what} table offsets inconsistent with {len(data)} data bytes")
    out, start = [], 0
    for e in ends:
        try:
            out.append(data[start:int(e)].decode("utf-8"))
        except UnicodeDecodeError as exc:
            raise PageFormatError(f"{what} table entry not UTF-8") from exc
        start = int(e)
    return out


def encode_page(page: OpPage) -> bytes:
    """Pack a page; the inverse of decode_page."""
    n = page.n_ops
    body = (np.asarray(page.seq, np.uint32).tobytes()
            + np.asarray(page.wire_ts, np.int32).tobytes()
            + np.asarray(page.key_id, np.uint32).tobytes()
            + np.asarray(page.val_id, np.uint32).tobytes())
    kt = _encode_table(page.keys)
    vt = _encode_table(page.values)
    payload = body + kt + vt
    header = _HEADER.pack(MAGIC, VERSION, 0, page.origin, page.page_seq,
                          n, len(kt), len(vt), zlib.crc32(payload))
    return header + payload


def decode_page(buf: bytes) -> OpPage:
    """Decode + validate one op page, or raise PageFormatError.

    Every check runs BEFORE the page is handed to admission: a page that
    decodes is safe to admit without further per-op validation."""
    if len(buf) < HEADER_SIZE:
        raise PageFormatError(f"short page: {len(buf)} < header {HEADER_SIZE}")
    magic, ver, flags, origin, page_seq, n, kb, vb, crc = _HEADER.unpack_from(
        buf, 0)
    if magic != MAGIC:
        raise PageFormatError(f"bad magic {magic!r}")
    if ver != VERSION:
        raise PageFormatError(f"unsupported page version {ver}")
    if flags != 0:
        raise PageFormatError(f"reserved flags set: {flags:#x}")
    if origin < 0:
        raise PageFormatError(f"negative origin {origin}")
    if n == 0:
        raise PageFormatError("empty page (n_ops == 0)")
    if n > MAX_OPS_PER_PAGE:
        raise PageFormatError(f"n_ops {n} over cap {MAX_OPS_PER_PAGE}")
    if kb > MAX_TABLE_BYTES or vb > MAX_TABLE_BYTES:
        raise PageFormatError("string table over byte cap")
    planes = 16 * n  # 4 planes x 4 bytes
    expect = HEADER_SIZE + planes + kb + vb
    if len(buf) != expect:
        raise PageFormatError(
            f"length mismatch: {len(buf)} bytes, header declares {expect}")
    payload = buf[HEADER_SIZE:]
    if zlib.crc32(payload) != crc:
        raise PageFormatError("crc32 mismatch")
    seq = np.frombuffer(buf, np.uint32, n, offset=HEADER_SIZE)
    wire_ts = np.frombuffer(buf, np.int32, n, offset=HEADER_SIZE + 4 * n)
    key_id = np.frombuffer(buf, np.uint32, n, offset=HEADER_SIZE + 8 * n)
    val_id = np.frombuffer(buf, np.uint32, n, offset=HEADER_SIZE + 12 * n)
    if n > 1 and not np.all(np.diff(seq.astype(np.int64)) > 0):
        raise PageFormatError("seq plane not strictly increasing")
    bad_ts = (wire_ts != WIRE_TS_NOW) & ((wire_ts < 0) | (wire_ts >= INT32_MAX))
    if np.any(bad_ts):
        raise PageFormatError(
            f"wire-ts outside [0, {INT32_MAX}) at row "
            f"{int(np.argmax(bad_ts))}")
    keys = _decode_table(buf[HEADER_SIZE + planes:HEADER_SIZE + planes + kb],
                         "key")
    values = _decode_table(buf[HEADER_SIZE + planes + kb:], "value")
    if np.any(key_id >= len(keys)):
        raise PageFormatError(
            f"key-id out of bounds (table has {len(keys)} entries)")
    if np.any(val_id >= len(values)):
        raise PageFormatError(
            f"value-id out of bounds (table has {len(values)} entries)")
    return OpPage(origin=origin, page_seq=page_seq, seq=seq.copy(),
                  wire_ts=wire_ts.copy(), key_id=key_id.copy(),
                  val_id=val_id.copy(), keys=keys, values=values)


@dataclass
class PageBuilder:
    """Client-side page assembly: interns keys/values page-locally, mints
    per-origin op seqs and page seqs, and emits packed pages.

    One builder == one writer stream (``origin``); the workload/soak
    harnesses hold one per client thread."""
    origin: int
    page_size: int = 512
    _seq: int = 0
    _page_seq: int = 0
    _keys: List[str] = field(default_factory=list)
    _kidx: Dict[str, int] = field(default_factory=dict)
    _values: List[str] = field(default_factory=list)
    _vidx: Dict[str, int] = field(default_factory=dict)
    _rows: List[Tuple[int, int, int, int]] = field(default_factory=list)

    def _intern(self, table, idx, s: str) -> int:
        i = idx.get(s)
        if i is None:
            i = idx[s] = len(table)
            table.append(s)
        return i

    def add(self, key: str, value: str, ts: int = WIRE_TS_NOW) -> Optional[bytes]:
        """Append one op; returns a packed page when the builder reaches
        ``page_size`` ops (else None — call flush() at end of stream)."""
        self._rows.append((self._seq, int(ts),
                           self._intern(self._keys, self._kidx, str(key)),
                           self._intern(self._values, self._vidx, str(value))))
        self._seq += 1
        if len(self._rows) >= self.page_size:
            return self.flush()
        return None

    def flush(self) -> Optional[bytes]:
        """Pack and clear the pending ops; None when nothing is pending."""
        if not self._rows:
            return None
        arr = np.asarray(self._rows, np.int64)
        page = OpPage(
            origin=self.origin, page_seq=self._page_seq,
            seq=arr[:, 0].astype(np.uint32),
            wire_ts=arr[:, 1].astype(np.int32),
            key_id=arr[:, 2].astype(np.uint32),
            val_id=arr[:, 3].astype(np.uint32),
            keys=list(self._keys), values=list(self._values),
        )
        self._page_seq += 1
        self._rows.clear()
        self._keys, self._kidx = [], {}
        self._values, self._vidx = [], {}
        return encode_page(page)
