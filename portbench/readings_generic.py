"""The readings a generic fit cell's limits are set from, at the cell's own
size: ``portbench/readings.py`` with the faults of the generic step
(``portbench/faults_generic.py``).

    python3 portbench/readings_generic.py --workload <name> --seeds 11 12 13 [--control] [--fault F]

For each seed: the cell's set-up and ``--window`` seconds of its traffic,
then its checked fit, then the numbers its run compares, from the program
(or the program with fault ``F`` planted), and with ``--control`` the same
numbers with the reference in bfloat16 put in the program's place.  One
JSON line a seed.  Needs the card the cell runs on.
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

from portbench import core, faults_generic  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", choices=faults_generic.FAULTS)
    # A fit of the hybrid cell takes about 6 s on the H100; the window must
    # finish at least one.
    parser.add_argument("--window", type=float, default=12.0)
    parser.add_argument("--detail", action="store_true",
                        help="each live leaf's gap after every step")
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
        with faults_generic.planted(args.fault) if args.fault else contextlib.nullcontext():
            run.setup()
            run.window(args.window)
        run.release()
        out = {"workload": cell.name, "seed": seed, "fault": args.fault,
               "program": run.checks()}
        if args.control:
            out["control"] = run.control()
        if args.detail:
            out["detail"] = run.detail()
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
