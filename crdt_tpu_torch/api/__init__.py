"""The replica node and the in-process cluster: the reference's own system
(a gossiped op-log key-value counter store) with its logs on the card."""
