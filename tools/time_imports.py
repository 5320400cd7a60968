"""Time the import a network daemon pays before it serves: a fresh Python
process that imports what ``python -m crdt_tpu_torch --daemon`` imports
(``api.net``, ``utils.config``, ``utils.checkpoint``), once for each tree
given, the trees alternating.

    python3 tools/time_imports.py [--root DIR ...] [--reps N]

Each ``--root`` is a checkout of the repository (default: this one); an
A/B unpacks the other commit under a git-ignored directory (``git archive
<commit> crdt_tpu_torch | tar -x -C build/parent``) and passes both.
Prints one JSON line a tree: the wall seconds of every process, their
median and their least.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

DAEMON_IMPORTS = ("from crdt_tpu_torch.api.net import NodeHost; "
                  "from crdt_tpu_torch.utils.config import ClusterConfig; "
                  "from crdt_tpu_torch.utils.checkpoint import bump_incarnation")


def once(root: Path) -> float:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", DAEMON_IMPORTS], cwd=root, check=True)
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", type=Path,
                    help="a checkout to time (repeatable; default: this one)")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    roots = [r.resolve() for r in (args.root or [Path(__file__).resolve().parent.parent])]
    for r in roots:
        once(r)  # warm the page cache and the bytecode caches
    times = {str(r): [] for r in roots}
    for _ in range(args.reps):
        for r in roots:
            times[str(r)].append(once(r))
    for r, ts in times.items():
        print(json.dumps({"root": r, "imports": DAEMON_IMPORTS, "seconds": ts,
                          "median_s": statistics.median(ts), "min_s": min(ts)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
