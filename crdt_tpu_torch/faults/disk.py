"""FaultyDisk — the storage boundary shim of the fault plane (own copy
of ``crdt_tpu.faults.disk``).

Wraps ``utils/checkpoint.save_node_atomic`` with schedule-driven disk
faults (op="disk" rules):

* delay    — fsync stall: every fsync inside the save sleeps rule.arg
             first (a loaded device / drive cache flush), via the
             checkpoint module's injection hook.
* truncate / corrupt — TORN WRITE: after the snapshot publishes, one of
             its manifest-listed files is byte-flipped WITHOUT updating
             the manifest — exactly what a kill mid-sector or bit rot
             produces.  The next restore must detect the digest mismatch,
             quarantine the snap, and fall back a generation
             (checkpoint.load_latest_node).

Also home to the planted-corruption helpers the soak and tests use to
stage recovery scenarios deterministically (``tear_snapshot``,
``plant_corruption``, ``point_latest_at_missing``).
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import random
from typing import Iterator, Optional, Tuple

from crdt_tpu_torch.faults.schedule import FaultPlane
from crdt_tpu_torch.utils import checkpoint as ckpt


@contextlib.contextmanager
def fsync_stall(seconds: float) -> Iterator[None]:
    """Every fsync in checkpoint writes sleeps ``seconds`` first while
    the context is held (stacking restores the previous value)."""
    prev = ckpt._FSYNC_STALL_S
    ckpt._FSYNC_STALL_S = max(0.0, seconds)
    try:
        yield
    finally:
        ckpt._FSYNC_STALL_S = prev


def tear_snapshot(snap_dir: str, rng: Optional[random.Random] = None) -> str:
    """Byte-flip one manifest-listed file of ``snap_dir`` without touching
    the manifest — the planted torn write.  Returns the damaged file's
    name."""
    rng = rng or random.Random("tear")
    p = pathlib.Path(snap_dir)
    manifest = json.loads((p / ckpt.MANIFEST_NAME).read_text())
    name = rng.choice(sorted(manifest["files"]))
    f = p / name
    data = bytearray(f.read_bytes())
    if not data:
        f.write_bytes(b"\xff")
        return name
    i = rng.randrange(len(data))
    data[i] ^= 0xFF
    f.write_bytes(bytes(data))
    return name


def plant_corruption(root: str,
                     rng: Optional[random.Random] = None) -> Optional[str]:
    """Corrupt the NEWEST snapshot under checkpoint root ``root`` (the one
    LATEST names, when present).  Returns the torn snap dir, or None when
    there is no manifested snapshot to corrupt."""
    rootp = pathlib.Path(root)
    latest = rootp / "LATEST"
    target = None
    if latest.exists():
        cand = rootp / latest.read_text().strip()
        if (cand / ckpt.MANIFEST_NAME).is_file():
            target = cand
    if target is None:
        snaps = [s for s in sorted(rootp.glob("snap-*"), reverse=True)
                 if (s / ckpt.MANIFEST_NAME).is_file()]
        target = snaps[0] if snaps else None
    if target is None:
        return None
    tear_snapshot(str(target), rng=rng)
    return str(target)


def point_latest_at_missing(root: str) -> None:
    """Make LATEST name a snap dir that does not exist (the kill-between-
    prune-and-repoint wreckage load_latest_node must survive)."""
    ckpt._replace_file(pathlib.Path(root) / "LATEST", "snap-99999999")


class FaultyDisk:
    """Schedule-driven checkpoint wrapper for one node (label = schedule
    src/dst; disk rules use op="disk")."""

    def __init__(self, plane: FaultPlane, label: str):
        self.plane = plane
        self.label = label

    def save(self, root: str, node, set_node=None, seq_node=None,
             map_node=None, composite_node=None, keyspace=None,
             leases=None) -> Tuple[str, bool]:
        """save_node_atomic under the current step's disk faults.
        Returns (snap_dir, torn): ``torn`` means the published snapshot
        was damaged post-write and must NOT be treated as durable by the
        caller's oracle (the restore path will quarantine it)."""
        faults = self.plane.decide(self.label, self.label, "disk")
        stall = faults.get("delay")
        if stall is not None:
            self.plane.record("fsync_stall", node=self.label,
                              arg=stall.arg)
        with fsync_stall(stall.arg if stall is not None else 0.0):
            snap = ckpt.save_node_atomic(
                root, node, set_node=set_node, seq_node=seq_node,
                map_node=map_node, composite_node=composite_node,
                keyspace=keyspace, leases=leases,
            )
        torn = False
        if "truncate" in faults or "corrupt" in faults:
            # deterministic tear: keyed by the same identity scheme as
            # the plane's coins so replays damage the same byte
            name = tear_snapshot(snap, rng=random.Random(
                f"{self.plane.schedule.seed}:{self.plane.step}:"
                f"{self.label}:disk:tear"
            ))
            self.plane.record("torn_write", node=self.label, file=name)
            torn = True
        return snap, torn
