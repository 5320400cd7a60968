"""Seeded adversarial soaks: ``gc_soak`` (the OR-Set and the OR-Map's
epoch resets) and ``seq_soak`` (the RSeq allocator and its tombstone GC),
each checked after every action against a GC-less Python mirror, and
``soak`` (the KV cluster under kill/revive and barriers, checked against
the oracle)."""
from crdt_tpu_torch.workload import WorkloadGenerator  # noqa: F401
