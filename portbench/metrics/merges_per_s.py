"""merges_per_s: the replica-merges the window completed over the window's
whole time (host clock).  A pull round counts one merge for each up
replica that joined an up peer, a barrier one for each up replica it
brings to the least upper bound, a columnar join one for each lane."""


def read(run):
    merges = run.totals.get("merges")
    return None if merges is None else merges / run.window_s
