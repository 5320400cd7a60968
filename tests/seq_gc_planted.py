"""Planted GC joins of RSeq lanes that meet each case of ``tomb_gc``'s
floor rule, shared by the GC swarm's CPU tests (the plain twin against the
JAX package) and its card tests (the fused kernel against the twin)."""
import torch

from crdt_tpu_torch.models import rseq, rseq_engine, tomb_gc

CAP_PLANTED = 8
W_PLANTED = 4


def _writer(rid: int, n: int, base=None) -> rseq.RSeq:
    w = rseq.SeqWriter(rseq.empty(CAP_PLANTED, device="cpu") if base is None else base, rid=rid)
    for i in range(n):
        w.append(100 * rid + i)
    return w.state


def _floor(**covered) -> torch.Tensor:
    """A floor of W_PLANTED writers, -1 but for ``w<rid>=seq``."""
    f = torch.full((W_PLANTED,), -1, dtype=torch.int32)
    for name, seq in covered.items():
        f[int(name[1:])] = seq
    return f


def planted_pairs():
    """Two batches of Gc[RSeq] lanes at C = 8 and 4 writers whose GC joins
    meet each case of the floor rule; with (n_unique, dropped) a lane:

    0. the lossless union (12 rows) exceeds C, and after the rule (B's 4
       rows of writer 1 that A's floor covers go) it fits: (8, 4);
    1. rows both sides hold, which both floors cover, are kept; A's own
       row of writer 2 that B's floor covers goes: (4, 1);
    2. B's rows of writer 5, a rid >= W, are never covered, though A's
       floor covers every writer it has; B's rows of writer 1 go: (5, 2);
    3. floors of -1 cover nothing: (6, 0);
    4. two dead lanes (empty tables, floors -1): (0, 0);
    5. a dead puller: (4, 0);
    6. an empty puller whose floor covers two of B's rows: (2, 2)."""
    empty = rseq.empty(CAP_PLANTED, device="cpu")
    base = _writer(0, 3)
    lanes = [
        ((_writer(0, 6), _floor(w1=3)), (_writer(1, 6), _floor())),
        ((_writer(2, 2, base), _floor(w0=5)), (base, _floor(w0=5, w2=0))),
        ((_writer(0, 2), _floor(w0=9, w1=9, w2=9, w3=9)), (_writer(1, 2, _writer(5, 3)), _floor())),
        ((_writer(0, 3), _floor()), (_writer(1, 3), _floor())),
        ((empty, _floor()), (empty, _floor())),
        ((empty, _floor()), (_writer(2, 4), _floor())),
        ((empty, _floor(w2=1)), (_writer(2, 4), _floor())),
    ]

    def batch(side):
        states = [lane[side][0] for lane in lanes]
        inner = rseq.RSeq(*(torch.stack([getattr(s, f) for s in states])
                            for f in ("keys", "elem", "removed")))
        return tomb_gc.Gc(inner=inner, floor=torch.stack([lane[side][1] for lane in lanes]))

    return batch(0), batch(1)


PLANTED_COUNTS = ([8, 4, 5, 6, 0, 4, 2], [4, 1, 2, 0, 0, 0, 2])


def staged_planted():
    a, b = planted_pairs()
    bits = rseq_engine.fit_joint_seq_bits(a.inner, b.inner)
    return rseq_engine.stack(a, seq_bits=bits), rseq_engine.stack(b, seq_bits=bits)
