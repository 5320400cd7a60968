"""join_roofline: the least time the window's OR-Set joins could take at
the card's memory bandwidth (``roofline.set_join_bytes`` a join), as a
share of the device time of all the work launched inside the benchmark's
spans around ``orset.columnar_join``."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.span_device_s("portbench.join")
    if not device_s or sum(device_s) <= 0:
        return None
    n_bytes = roofline.set_join_bytes(run.config["capacity"], run.config["replicas"])
    return 100 * len(device_s) * roofline.bound_s(n_bytes) / sum(device_s)
