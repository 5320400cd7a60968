"""device_idle.read: the share of the traced window in which no device op
ran (profiler), in a cell whose end-to-end rate is views."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
