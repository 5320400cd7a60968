"""The device-parallel layer: ``swarm`` (replicas as rows on one card),
``mesh`` and ``multihost`` (the replica axis over the ranks of a
``torch.distributed`` process group), ``pipeline`` (double-buffered
stripes) and ``meshplane`` (the keyspace's fused shard fold).

The JAX package's ``parallel/compat.py`` has no counterpart: it absorbs
the version drift of ``jax.shard_map`` and ``jax.distributed``, and the
port uses neither.  Its ``distributed_is_initialized`` is
``torch.distributed.is_initialized()``.
"""
from crdt_tpu_torch.parallel import mesh, swarm  # noqa: F401
