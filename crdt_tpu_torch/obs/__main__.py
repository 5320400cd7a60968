"""CLI entry (own copy of ``python -m crdt_tpu.obs``):
``python -m crdt_tpu_torch.obs fleet <members...>`` and
``python -m crdt_tpu_torch.obs audit <members...>``.  ``assemble`` (the
cross-node trace assembler, ``crdt_tpu.obs.assemble``) is not ported yet
(ROADMAP Queue 1 item 3b) and exits 2 naming it."""
from __future__ import annotations

import sys

ASSEMBLE_NOT_PORTED = ("assemble: the trace assembler is not ported "
                       "(ROADMAP Queue 1 item 3b: obs/assemble)")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m crdt_tpu_torch.obs fleet <url-or-file ...> "
              "[--logs node.jsonl ...] [--min-coverage 95] "
              "[--out fleet.json]\n"
              "       python -m crdt_tpu_torch.obs audit <url-or-file ...> "
              "[--out audit.json]")
        return 0 if argv else 2
    cmd = argv.pop(0)
    if cmd == "assemble":
        print(ASSEMBLE_NOT_PORTED, file=sys.stderr)
        return 2
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
