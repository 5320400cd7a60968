"""The control of ``correct``, and the program's readings beside it, at a
cell's own size on several seeds in one process:

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--program]

Without ``--program`` each seed runs the cell's control in the program's
place: the plain reference with one guarantee of the configuration
broken (``portbench/systems/<system>.py``'s ``Control``), which must come
out not correct.  With ``--program`` each seed runs the program as a
measured run does.  One JSON line a seed gives every number compared and
its limit.  The benchmark's own runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from portbench import harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.Spec(ROOT)
    config = spec.config(spec.cells[args.workload])
    module = importlib.import_module(f"portbench.systems.{config['system']}")
    for seed in args.seeds:
        system = None if args.program else module.Control()
        t0 = time.perf_counter() if seed != args.seeds[0] else T0
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, "cuda", t0,
                               system=system)
        r = out["result"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "arm": "program" if args.program else "control",
                          "correct": r["correct"], "attempted": r["attempted"],
                          "failed": r["failed"], "compared": r["compared"],
                          "memory_peak_bytes": r["device"]["memory_peak_bytes"]}), flush=True)
        del out, system
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
