"""Bit-packing an OR-Set tag (elem, rid, seq) into one int32 key
(counterpart of ``crdt_tpu.ops.pack``).

The columnar union kernels compare one int32 key plane; the generic path
compares the three columns lexicographically.  The default split is
elem:14 | rid:6 | seq:11 bits (16K elements, 64 replicas of origin, 2K
seqs), leaving the sign bit clear, so packed keys are non-negative and
lexicographic order of (elem, rid, seq) is numeric order of the packed
word.  Budgets are checked before packing: an over-budget field bleeds into
its neighbour, two distinct tags can collide, and collided tags merge in a
join — permanent data loss.
"""
from __future__ import annotations

import torch

ELEM_BITS, RID_BITS, SEQ_BITS = 14, 6, 11
assert ELEM_BITS + RID_BITS + SEQ_BITS == 31  # sign bit stays clear


def pack_tags(elem: torch.Tensor, rid: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """Pack (elem, rid, seq) int32 columns into one order-preserving int32.
    Padding rows pack to whatever the shifts give (int32 wraps); callers
    pack valid rows and re-pad with SENTINEL."""
    return ((elem << (RID_BITS + SEQ_BITS)) | (rid << SEQ_BITS) | seq).to(torch.int32)


def unpack_tags(packed: torch.Tensor):
    seq = packed & ((1 << SEQ_BITS) - 1)
    rid = (packed >> SEQ_BITS) & ((1 << RID_BITS) - 1)
    elem = (packed >> (RID_BITS + SEQ_BITS)) & ((1 << ELEM_BITS) - 1)
    return elem, rid, seq


def pack_tags_checked(elem, rid, seq, valid=None):
    """:func:`pack_tags` that raises ValueError when any VALID row exceeds
    its field's bit budget or is negative.  ``valid`` masks out padding rows
    (SENTINEL rows would always trip the check); ``None`` checks every row.
    The check runs on the tensors' device — one min and one max per field,
    read back in a single transfer — so a swarm's planes never go to the
    host.  Returns the packed int32 tensor for every row (padding rows pack
    to whatever pack_tags yields — callers re-pad with SENTINEL)."""
    cols = [torch.as_tensor(x, dtype=torch.int32) for x in (elem, rid, seq)]
    device = cols[0].device
    cols = [x.to(device) for x in cols]
    mask = None if valid is None else torch.as_tensor(valid, dtype=torch.bool).to(device)
    stats = []
    for col in cols:
        # padding rows read as 0, which is inside every budget
        sel = col if mask is None else col.masked_fill(~mask, 0)
        if sel.numel():
            stats += [sel.amin(), sel.amax()]
        else:
            stats += [sel.new_zeros(()), sel.new_zeros(())]
    lo_hi = torch.stack(stats).tolist()
    for k, (name, bits) in enumerate((("elem", ELEM_BITS), ("rid", RID_BITS),
                                      ("seq", SEQ_BITS))):
        lo, hi = lo_hi[2 * k], lo_hi[2 * k + 1]
        if lo < 0 or hi >= 1 << bits:
            bad = lo if lo < 0 else hi
            raise ValueError(
                f"{name} value {bad} outside the {bits}-bit packed budget "
                f"[0, {1 << bits}); packing would corrupt keys — widen the "
                "budget split or use the generic sorted_union path"
            )
    return pack_tags(*cols)


def check_budget(n_elems: int, n_rids: int, n_seqs: int) -> None:
    if n_elems > 1 << ELEM_BITS or n_rids > 1 << RID_BITS or n_seqs > 1 << SEQ_BITS:
        raise ValueError(
            f"tag space ({n_elems}, {n_rids}, {n_seqs}) exceeds the packed "
            f"budget ({1 << ELEM_BITS}, {1 << RID_BITS}, {1 << SEQ_BITS}); "
            "use the generic crdt_tpu_torch.ops.sorted_union path instead"
        )
