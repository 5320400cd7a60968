"""The replica node and the in-process cluster: the reference's own system
(a gossiped op-log key-value counter store) with its logs on the card."""
from crdt_tpu_torch.api.node import ReplicaNode  # noqa: F401
from crdt_tpu_torch.api.cluster import LocalCluster  # noqa: F401
from crdt_tpu_torch.api.net import NetworkAgent, NodeHost, RemotePeer  # noqa: F401
from crdt_tpu_torch.api.seqnode import SeqNode  # noqa: F401
from crdt_tpu_torch.api.setnode import SetNode  # noqa: F401
