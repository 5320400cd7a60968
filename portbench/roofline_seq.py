"""The least bytes of the sequence CRDT's GC pull, from the call's shapes,
for ``gc_pull_roofline.seq``, counted as ``roofline.py`` counts them
(whose ``bound_s`` gives the time at the card's peak): each input byte
read once and each output byte written once.  The bytes bound the union:
its int32 compares at the card's int32 rate take a small share of the
time the bytes do.
"""
from __future__ import annotations


def gc_pull_planes(depth: int) -> int:
    """int32 planes a side of the GC pull's union (kernel 1 at (3·D, 3)):
    3·D key words, then elem, removed and the side marker."""
    return 3 * depth + 3


def gc_pull_bytes(capacity: int, replicas: int, depth: int) -> int:
    """One GC pull's union: both sides' planes read (C rows a lane), the
    lossless union written (2C rows a lane), and the unique count a lane.
    At RSeq's depth 6, C = 1,024 and R = 10,240: (2·21 + 42)·C·R·4 + 4R,
    3.52 GB."""
    planes = gc_pull_planes(depth)
    return (2 * planes + 2 * planes) * capacity * replicas * 4 + 4 * replicas
