"""Shared constants for tensor-encoded CRDT state (counterpart of
``crdt_tpu.utils.constants``).

Everything device-side is int32.  Timestamps are millisecond offsets from
a host-side epoch so they fit int32; uniqueness comes from the
(ts, replica_id, seq) triple.
"""
import numpy as np
import torch

# Padding sentinel for sorted tensor-encoded sets/logs.  Real keys are
# strictly below it, so padded rows sort to the tail.
SENTINEL = np.int32(2**31 - 1)
SENTINEL_PY = 2**31 - 1

# "No value yet" timestamp for LWW registers (all real ts are >= 0).
TS_NULL = np.int32(-1)

DEFAULT_DTYPE = torch.int32
