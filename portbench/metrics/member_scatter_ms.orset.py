"""member_scatter_ms.orset: the median, over the window's member masks, of
the device time of the work launched inside the program's own
``orset.columnar_member_mask.scatter`` span (the ``scatter_reduce_``
over the tags' rows and the final compare); nothing where no such span
launched device work."""

import statistics


def read(run):
    if run.trace is None:
        return None
    times = [s for s in run.trace.span_device_s("orset.columnar_member_mask.scatter") if s > 0]
    return statistics.median(times) * 1e3 if times else None
