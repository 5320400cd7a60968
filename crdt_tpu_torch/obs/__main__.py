"""CLI entry (own copy of ``python -m crdt_tpu.obs``):
``python -m crdt_tpu_torch.obs assemble <logs...>``,
``python -m crdt_tpu_torch.obs fleet <members...>`` and
``python -m crdt_tpu_torch.obs audit <members...>``."""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m crdt_tpu_torch.obs assemble <node.jsonl ...> "
              "[--fault-log F] [--out trace.json] [--blame blame.json] "
              "[--min-coverage 0.95]\n"
              "       python -m crdt_tpu_torch.obs fleet <url-or-file ...> "
              "[--logs node.jsonl ...] [--min-coverage 95] "
              "[--out fleet.json]\n"
              "       python -m crdt_tpu_torch.obs audit <url-or-file ...> "
              "[--out audit.json]")
        return 0 if argv else 2
    cmd = argv.pop(0)
    if cmd == "assemble":
        from crdt_tpu_torch.obs.assemble import main as assemble_main

        return assemble_main(argv)
    if cmd == "fleet":
        from crdt_tpu_torch.obs.fleet import main as fleet_main

        return fleet_main(argv)
    if cmd == "audit":
        from crdt_tpu_torch.obs.audit import main as audit_main

        return audit_main(argv)
    print(f"unknown subcommand {cmd!r} (only: assemble, fleet, audit)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
