"""Seeded adversarial soaks of the GC'd lattices: ``gc_soak`` (the OR-Set
and the OR-Map's epoch resets) and ``seq_soak`` (the RSeq allocator and
its tombstone GC), each checked after every action against a GC-less
Python mirror."""
