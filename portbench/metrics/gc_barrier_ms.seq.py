"""gc_barrier_ms.seq: the median, over the window's GC barriers, of the
device extent of the program's own ``rseq_engine.gc_barrier`` span: from
the start of the first device op it launched to the end of its last, the
idle gaps between them included (where the host issues the halvings more
slowly than the device runs them)."""

import statistics


def read(run):
    if run.trace is None:
        return None
    extents = run.trace.span_extent_s("rseq_engine.gc_barrier")
    return statistics.median(extents) * 1e3 if extents else None
