"""ctypes bindings for the port's native host runtime (``ingest.cpp``):
the string interner, the Go ``Atoi`` parser, the op-batch packer and the
gossip wire store (own copy of the JAX package's ``native`` module).

Nothing is built at import time.  The first caller (the first native
``ReplicaNode``) compiles ``ingest.cpp`` with ``g++`` into
``build/native/libcrdt_ingest-<hash>.so`` at the repository root
(git-ignored), the hash taken over the source and the flags, so a changed
source is rebuilt and an unchanged one reused.  Concurrent first uses (test
workers, daemons started together) take a file lock around the build and
write a per-pid temporary that ``os.replace`` moves into place, so each
ends up loading a whole library.  A failed build raises with the
compiler's output: there is no quiet fallback to the Python path.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

# True once this process has loaded the runtime (``lib()``); a node is
# native by default all the same, and builds the library at first use
AVAILABLE = False
_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcrdt_ingest-{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():  # another process built it while we waited
            return
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{CXX} could not run to build {SOURCE.name}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{CXX} failed to build {SOURCE.name} "
                               f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)


def lib() -> ctypes.CDLL:
    """The loaded runtime, built at first use."""
    global _lib, AVAILABLE
    with _LOCK:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _compile(target)
            _lib = _bind(ctypes.CDLL(str(target)))
            AVAILABLE = True
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.crdt_interner_new.restype = ctypes.c_void_p
    lib.crdt_interner_free.argtypes = [ctypes.c_void_p]
    lib.crdt_intern.restype = ctypes.c_int32
    lib.crdt_intern.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    lib.crdt_interner_size.restype = ctypes.c_int32
    lib.crdt_interner_size.argtypes = [ctypes.c_void_p]
    lib.crdt_interner_find.restype = ctypes.c_int32
    lib.crdt_interner_find.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    lib.crdt_lookup.restype = ctypes.POINTER(ctypes.c_char)
    lib.crdt_lookup.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                ctypes.POINTER(ctypes.c_int32)]
    lib.crdt_parse_go_int.restype = ctypes.c_int32
    lib.crdt_parse_go_int.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                      ctypes.POINTER(ctypes.c_int32)]
    lib.crdt_batch_new.restype = ctypes.c_void_p
    for name in ("crdt_batch_free", "crdt_batch_clear"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.crdt_batch_add.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
    ]
    lib.crdt_batch_size.restype = ctypes.c_int32
    lib.crdt_batch_size.argtypes = [ctypes.c_void_p]
    for name in ("ts", "rid", "seq", "key", "val", "payload"):
        fn = getattr(lib, f"crdt_batch_{name}")
        fn.restype = ctypes.POINTER(ctypes.c_int32)
        fn.argtypes = [ctypes.c_void_p]
    lib.crdt_batch_is_num.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.crdt_batch_is_num.argtypes = [ctypes.c_void_p]
    lib.crdt_wire_new.restype = ctypes.c_void_p
    lib.crdt_wire_free.argtypes = [ctypes.c_void_p]
    lib.crdt_wire_add.restype = ctypes.c_int32
    lib.crdt_wire_add.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.crdt_wire_add_many.restype = ctypes.c_int32
    lib.crdt_wire_add_many.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        *[ctypes.POINTER(ctypes.c_int32)] * 5,
    ]
    lib.crdt_wire_remove.restype = ctypes.c_int32
    lib.crdt_wire_remove.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_int32]
    lib.crdt_wire_size.restype = ctypes.c_int32
    lib.crdt_wire_size.argtypes = [ctypes.c_void_p]
    lib.crdt_wire_payload.restype = ctypes.POINTER(ctypes.c_char)
    lib.crdt_wire_payload.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


class _Handle:
    """A C++ object owned by one Python object, freed with it."""

    _free = ""

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            getattr(self._lib, self._free)(h)
            self._h = None


class NativeInterner(_Handle):
    """The C++ counterpart of ``utils.intern.Interner`` (the same dense
    insertion-ordered ids)."""

    _free = "crdt_interner_free"

    def __init__(self):
        self._lib = lib()
        self._h = self._lib.crdt_interner_new()

    def intern(self, s: str) -> int:
        b = s.encode()
        return self._lib.crdt_intern(self._h, b, len(b))

    def lookup(self, i: int) -> str:
        n = ctypes.c_int32()
        p = self._lib.crdt_lookup(self._h, i, ctypes.byref(n))
        if n.value < 0:
            raise IndexError(i)
        return ctypes.string_at(p, n.value).decode()

    def __len__(self) -> int:
        return self._lib.crdt_interner_size(self._h)

    def __contains__(self, s: str) -> bool:
        b = s.encode()
        return self._lib.crdt_interner_find(self._h, b, len(b)) >= 0


def parse_go_int(s: str) -> Optional[int]:
    """The C++ twin of ``utils.intern.parse_go_int``."""
    b = s.encode()
    out = ctypes.c_int32()
    if lib().crdt_parse_go_int(b, len(b), ctypes.byref(out)):
        return out.value
    return None


class OpBatchPacker(_Handle):
    """Accumulates (ts, rid, seq, key, value) op rows in C++ (interning
    both strings and parsing the value) and hands out the packed columns
    as numpy arrays (copied out by ``take``, which clears the batch)."""

    _free = "crdt_batch_free"
    _COLS = ("ts", "rid", "seq", "key", "val", "payload")

    def __init__(self, keys: NativeInterner, vals: NativeInterner):
        self._lib = lib()
        self.keys, self.vals = keys, vals
        self._h = self._lib.crdt_batch_new()

    def add(self, ts: int, rid: int, seq: int, key: str, val: str) -> None:
        kb, vb = key.encode(), val.encode()
        self._lib.crdt_batch_add(self._h, self.keys._h, self.vals._h, ts, rid, seq,
                                 kb, len(kb), vb, len(vb))

    def __len__(self) -> int:
        return self._lib.crdt_batch_size(self._h)

    def take(self) -> dict:
        n = len(self)
        cols = {}
        for name in self._COLS:
            p = getattr(self._lib, f"crdt_batch_{name}")(self._h)
            cols[name] = np.ctypeslib.as_array(p, shape=(n,)).copy()
        p = self._lib.crdt_batch_is_num(self._h)
        cols["is_num"] = np.ctypeslib.as_array(p, shape=(n,)).astype(bool)
        self._lib.crdt_batch_clear(self._h)
        return cols


class WireStore(_Handle):
    """A node's op -> command map mirrored in C++, keyed by the ABSOLUTE
    wire key ``(ts + epoch, rid, seq)`` each op got when it entered, with
    a direct-to-JSON gossip payload emitter (``{"ts:rid:seq":{"k":"v",...},
    ...}`` in identity order, no whitespace, strings escaped byte-wise)."""

    _free = "crdt_wire_free"

    def __init__(self, keys: NativeInterner, vals: NativeInterner):
        self._lib = lib()
        self.keys, self.vals = keys, vals
        self._h = self._lib.crdt_wire_new()

    def add(self, ts_abs: int, rid: int, seq: int, cmd: dict) -> bool:
        return self.add_ids(ts_abs, rid, seq, [self.keys.intern(k) for k in cmd],
                            [self.vals.intern(v) for v in cmd.values()])

    def add_ids(self, ts_abs: int, rid: int, seq: int, kids, vids) -> bool:
        """``add`` with pre-interned key and value ids (the batched write
        path interns each distinct string once a batch)."""
        n = len(kids)
        ka = (ctypes.c_int32 * n)(*kids)
        va = (ctypes.c_int32 * n)(*vids)
        return bool(self._lib.crdt_wire_add(self._h, ts_abs, rid, seq, n, ka, va))

    def add_many(self, ts_abs, rid, seq, n_pairs, kids, vids) -> int:
        """``add_ids`` of many ops in one call (the write-behind queue's
        drain): op i is (ts_abs[i], rid[i], seq[i]) with n_pairs[i] pairs
        taken in order from kids/vids.  Returns how many were fresh."""
        cols = [np.ascontiguousarray(ts_abs, np.int64)] + [
            np.ascontiguousarray(c, np.int32) for c in (rid, seq, n_pairs, kids, vids)]
        if len(cols[4]) != int(cols[3].sum()) or len(cols[5]) != len(cols[4]):
            raise ValueError("add_many: the pair counts do not match the key and value ids")
        ptrs = [c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64 if c.dtype == np.int64
                                                else ctypes.c_int32)) for c in cols]
        return self._lib.crdt_wire_add_many(self._h, len(cols[0]), *ptrs)

    def remove(self, ts_abs: int, rid: int, seq: int) -> bool:
        return bool(self._lib.crdt_wire_remove(self._h, ts_abs, rid, seq))

    def __len__(self) -> int:
        return self._lib.crdt_wire_size(self._h)

    def payload_json(self, since: Optional[dict]) -> bytes:
        """The gossip payload as UTF-8 JSON bytes; ``since`` is the
        requester's version vector (None: a full dump).  rid<0 ops carry no
        watermark and always ride."""
        vv = since or {0: 0}
        rids = (ctypes.c_int32 * len(vv))(*vv)
        seqs = (ctypes.c_int32 * len(vv))(*vv.values())
        out_len = ctypes.c_int32()
        p = self._lib.crdt_wire_payload(
            self._h, self.keys._h, self.vals._h, 1 if since is not None else 0,
            rids, seqs, len(since) if since else 0, ctypes.byref(out_len))
        return ctypes.string_at(p, out_len.value)
