"""The consistency plane's parts the port has: the version-vector
watermark lattice ``vvclock``, session tokens (``session``) and stability
summaries (``stability``).  The quorum plane and the leases of
``crdt_tpu.consistency`` are not ported."""
