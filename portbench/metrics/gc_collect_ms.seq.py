"""gc_collect_ms.seq: the median, over the window's GC barriers, of the
device time of the work launched inside the program's own
``rseq_engine.gc_barrier.collect`` span (the coverage of the removed rows
by the new floor and their compaction out of the bound's table); nothing
where no such span launched device work."""

import statistics


def read(run):
    if run.trace is None:
        return None
    times = [s for s in run.trace.span_device_s("rseq_engine.gc_barrier.collect") if s > 0]
    return statistics.median(times) * 1e3 if times else None
