"""crdt_tpu_torch — the PyTorch/CUDA port of ``crdt_tpu``.

The JAX package ``crdt_tpu`` stays the reference: every module here keeps
its counterpart's name and public functions, and the tests hold the two
bit for bit on seeded inputs.  This package imports ``torch``, numpy and
the standard library only — never ``jax`` and nothing of ``crdt_tpu``.

Layout (mirrors ``crdt_tpu``):

- ``utils``    — constants, table growth, host string interning;
- ``ops``      — ``sorted_union`` (plain torch) and ``hopper_union`` (the
  hand-written CUDA fused lexN union kernel, ``csrc/lexn_union.cu``);
- ``models``   — ``oplog``, ``oplog_columnar``, ``oplog_engine``;
- ``parallel`` — ``swarm`` (anti-entropy over a stacked replica axis);
- ``convert``  — state carried across from the JAX package as numpy;
- ``workload`` — seeded reference-shaped writes for driving a swarm.

Device rule: every constructor takes ``device=None``, which resolves to
the CUDA card (:func:`default_device`); without a card that raises rather
than quietly running on the CPU.  Functions that take tensors run on the
tensors' device.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """Resolve a constructor's ``device`` argument: ``None`` means the CUDA
    card, and raises if there is none — pass ``device="cpu"`` explicitly
    to build state on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "crdt_tpu_torch: no CUDA device is available; pass device='cpu' "
            "explicitly to build state on the CPU"
        )
    return torch.device("cuda")
