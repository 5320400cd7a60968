from crdt_tpu_torch.ops import joins, sorted_union  # noqa: F401
