"""Deterministic fault-injection plane, the nemesis (own copy of
``crdt_tpu.faults``).

Seeded, replayable fault schedules applied at the runtime's two I/O
boundaries: the wire (``FaultyTransport`` around ``api.net.RemotePeer``)
and the disk (``FaultyDisk`` around ``utils.checkpoint``), plus the
planted-corruption helpers the recovery tests use.  Pure host Python: no
tensor crosses this package.  See ``crdt_tpu_torch/faults/README.md`` for
each fault's semantics and ``harness/nemesis_soak.py`` for the runner
that composes them.
"""
from crdt_tpu_torch.faults.disk import (
    FaultyDisk,
    fsync_stall,
    plant_corruption,
    point_latest_at_missing,
    tear_snapshot,
)
from crdt_tpu_torch.faults.schedule import (
    KINDS,
    FaultPlane,
    FaultRule,
    NemesisSchedule,
    SkewEvent,
)
from crdt_tpu_torch.faults.transport import FaultyTransport, corrupt_page_bytes

__all__ = [
    "KINDS",
    "FaultPlane",
    "FaultRule",
    "FaultyDisk",
    "FaultyTransport",
    "NemesisSchedule",
    "SkewEvent",
    "corrupt_page_bytes",
    "fsync_stall",
    "plant_corruption",
    "point_latest_at_missing",
    "tear_snapshot",
]
