"""round_gather_ms.kv: the median, over the window's pull rounds, of the
device time of the work launched inside the program's own
``oplog_columnar.gossip_round.gather`` span (the peer lanes' gather,
``x[:, peers]``); nothing where no such span launched device work."""

import statistics


def read(run):
    if run.trace is None:
        return None
    times = [s for s in run.trace.span_device_s("oplog_columnar.gossip_round.gather") if s > 0]
    return statistics.median(times) * 1e3 if times else None
