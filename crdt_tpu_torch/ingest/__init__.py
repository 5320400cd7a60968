"""The ingest front door (own copy of ``crdt_tpu.ingest``): three layers
between the HTTP surface and the node's write path.

* :mod:`crdt_tpu_torch.ingest.wire`: the columnar op-page wire format
  (``POST /ingest/page``) and the client-side :class:`PageBuilder`;
* :mod:`crdt_tpu_torch.ingest.admission`: bounded micro-batching admission
  lanes that drain every pending write in ONE ``add_commands`` (one
  device merge) per drain;
* :mod:`crdt_tpu_torch.ingest.shed`: deterministic, counted backpressure
  (429 + Retry-After past the high-water mark).
"""
from crdt_tpu_torch.ingest.admission import (  # noqa: F401
    AdmissionQueue,
    DrainClaim,
    IngestFrontDoor,
    Ticket,
    front_door_from_config,
)
from crdt_tpu_torch.ingest.shed import ShedError, ShedPolicy  # noqa: F401
from crdt_tpu_torch.ingest.wire import (  # noqa: F401
    WIRE_TS_NOW,
    OpPage,
    PageBuilder,
    PageFormatError,
    decode_page,
    encode_page,
)
