"""gossip_round_roofline: the least time the window's pull rounds could
take at the card's memory bandwidth (``roofline.gossip_round_bytes`` a
round), as a share of the device time of all the work launched inside
the benchmark's spans around them: the peer gather, the union kernel and
the up-replica gating alike."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.span_device_s("portbench.gossip_round")
    if not device_s or sum(device_s) <= 0:
        return None
    n_bytes = roofline.gossip_round_bytes(run.config["capacity"], run.config["replicas"])
    return 100 * len(device_s) * roofline.bound_s(n_bytes) / sum(device_s)
