"""epoch_ms_p95: the 95th percentile, over every epoch of the window, of
the time from the epoch's start until its result has been read back to
the host (host clock; closed loop, one driver)."""

import statistics


def read(run):
    if len(run.epoch_s) < 2:
        return None
    return statistics.quantiles(run.epoch_s, n=20, method="inclusive")[18] * 1e3
