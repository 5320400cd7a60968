"""The reference-semantics oracle (own plain-Python copy of
``crdt_tpu.oracle``), so the node's views can be checked on a machine
without JAX; ``shim`` serves its quirks-on mode over HTTP."""
from crdt_tpu_torch.oracle.replica import OracleReplica, Quirks  # noqa: F401
