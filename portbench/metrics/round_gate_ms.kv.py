"""round_gate_ms.kv: the median, over the window's pull rounds, of the
device time of the work launched inside the program's own
``oplog_columnar.gossip_round.gate`` span (the up-replica test and the
four ``torch.where``s that keep a lane whose pull is gated off); nothing
where no such span launched device work."""

import statistics


def read(run):
    if run.trace is None:
        return None
    times = [s for s in run.trace.span_device_s("oplog_columnar.gossip_round.gate") if s > 0]
    return statistics.median(times) * 1e3 if times else None
