"""Time the lexN union kernel at the OpLog's split (2 key words, 2 value
planes) on chip_smoke.py's OpLog timing input: C=1024 rows x L=10,240
lanes, two seeded 40% subsets of the reference-shaped write pool.

    python3 tools/time_lexn_union.py [--root CHECKOUT] [--reps N]

``--root`` picks the checkout whose ``crdt_tpu_torch`` is imported and
built (default: the one holding this script), so that two versions of the
kernel compare on one card in one session: unpack the other version with
``git archive`` into a git-ignored directory and run the two alternately
(parent, change, change, parent).  Prints one JSON line: the card's name
and power limit, the median ms a call over ``--reps`` CUDA-event-timed
calls after two warm-up calls, every call's time, and a checksum of the
union's output, so that the versions can be seen to agree.  Exits 1
without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SEED = 20240           # chip_smoke.py's seed and shapes
R, C = 10_240, 1024
N_KEYS = 62


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_lexn_union: no CUDA device available", file=sys.stderr)
        return 1
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.models import oplog_columnar as oc
    from crdt_tpu_torch.ops import hopper_union as hu

    w = workload.reference_writes(C, R, SEED)

    def planes(seed):
        logs, _ = workload.subset_swarm(w.ops, R, C, 0.4, seed, device="cuda")
        col = oc.stack(logs, bits=oc.fit_bits(R, N_KEYS))
        return [col.hi, col.lo, col.val, col.pay]

    a, b = planes(SEED + 1), planes(SEED + 2)

    def call():
        return hu.sorted_union_columnar_fused_lexn(a[:2], a[2:], b[:2], b[2:], out_size=C)

    keys, vals, nu = call()
    checksum = sum(int(p.long().sum()) * (i + 1) for i, p in enumerate((*keys, *vals, nu)))
    call()
    times = []
    for _ in range(args.reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "card": card, "C": C, "L": R,
                      "median_ms": statistics.median(times), "ms": times,
                      "checksum": checksum}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
