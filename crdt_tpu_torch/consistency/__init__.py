"""The consistency plane's lattice: the version-vector watermark
``vvclock`` (the rest of ``crdt_tpu.consistency`` is host protocol and is
not ported)."""
