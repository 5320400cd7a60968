"""gc_pull_roofline.seq: the least time the window's GC pulls' unions could
take at the card's memory bandwidth (``roofline_seq.gc_pull_bytes`` a
pull: kernel 1 at 3·D key words and three value planes, out 2C), as a
share of the device time of the work launched inside the program's own
``rseq_engine.gc_gossip_round.union`` spans (the side markers and the
union kernel); nothing where no such span launched device work."""

from portbench import roofline, roofline_seq


def read(run):
    if run.trace is None:
        return None
    device_s = [s for s in run.trace.span_device_s("rseq_engine.gc_gossip_round.union") if s > 0]
    if not device_s:
        return None
    n_bytes = roofline_seq.gc_pull_bytes(run.config["capacity"], run.config["replicas"],
                                         run.config["depth"])
    return 100 * len(device_s) * roofline.bound_s(n_bytes) / sum(device_s)
