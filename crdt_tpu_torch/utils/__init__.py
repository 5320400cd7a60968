from crdt_tpu_torch.utils import clock, config, constants, intern, metrics  # noqa: F401
