"""unstack_ms.kv: the median, over the window's rebuilds, of the device
time of the work launched inside the program's own
``oplog_columnar.rebuild.unstack`` span (the transposes and ``where``s
back to row-major logs); nothing where no such span launched device
work."""

import statistics


def read(run):
    if run.trace is None:
        return None
    times = [s for s in run.trace.span_device_s("oplog_columnar.rebuild.unstack") if s > 0]
    return statistics.median(times) * 1e3 if times else None
