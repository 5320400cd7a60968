"""member_mask_ms.orset: the median device extent of the benchmark's span
around each ``orset.columnar_member_mask``."""

import statistics


def read(run):
    if run.trace is None:
        return None
    extents = run.trace.span_extent_s("portbench.member_mask")
    return statistics.median(extents) * 1e3 if extents else None
