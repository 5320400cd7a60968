"""halving_issue_us.kv: the median host duration of one halving of the
barrier's tree reduction, the program's own
``oplog_columnar.converge.halving`` span (two lane slices, kernel 1's
launch, the unique count's max): how long the host takes to issue one
halving.  Set beside ``barrier_ms.kv``, it says whether the host or the
device paces the barrier."""

import statistics


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.spans.get("oplog_columnar.converge.halving")
    return statistics.median(e - s for s, e in spans) * 1e6 if spans else None
