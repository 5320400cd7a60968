"""gc_pull_ms.seq: the median, over the window's GC pull rounds, of the
device time of the work launched inside the program's own
``rseq_engine.gc_gossip_round`` span (the peer gather, the union, the
floor suppression and compaction, the up-replica gating); nothing where
no such span launched device work."""

import statistics


def read(run):
    if run.trace is None:
        return None
    times = [s for s in run.trace.span_device_s("rseq_engine.gc_gossip_round") if s > 0]
    return statistics.median(times) * 1e3 if times else None
