"""rebuild_ms.kv: the median device extent of the benchmark's span around
each ``OpLogSwarm.rebuild`` (the unstack and the scatters of the views)."""

import statistics


def read(run):
    if run.trace is None:
        return None
    extents = run.trace.span_extent_s("portbench.rebuild")
    return statistics.median(extents) * 1e3 if extents else None
