"""The readings the limits of ``bpr-adagrad-l2.fit-partial`` and
``warp-mf-d64.eval-fresh`` are set from, at the cells' own size:
``portbench/readings.py`` with the BPR faults (``portbench/faults_bpr.py``).

    python3 portbench/readings_bpr.py --workload <name> --seeds 11 12 13 [--control] [--fault F]

For each seed: the cell's set-up and ``--window`` seconds of its traffic,
then the numbers its run compares, from the program (or the program with
fault ``F`` planted in its checked call, a fit cell only), and with
``--control`` the same numbers with the cell's control put in the
program's place.  One JSON
line a seed.  Needs the card the cell runs on.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import core, faults_bpr  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", choices=faults_bpr.FAULTS)
    parser.add_argument("--window", type=float, default=5.0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = core.Cell(args.workload)
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = driver.Run(cell, seed, device)
        with faults_bpr.in_checked_call(args.fault) if args.fault else contextlib.nullcontext():
            run.setup()
            run.window(args.window)
        run.release()
        out = {"workload": cell.name, "seed": seed, "fault": args.fault,
               "program": run.checks()}
        if args.control:
            out["control"] = run.control()
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
