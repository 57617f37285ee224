"""Run the whole-fit kernel K5 on ``chip_smoke.py``'s phase-7 inputs and
compare final states across two checkouts of the port, bitwise.

    python3 tools/torch_k5_compare.py --save OUT.npz [--tree DIR] [--seed 0]
    python3 tools/torch_k5_compare.py --save OUT.npz --against OTHER.npz

``--tree DIR`` imports ``lightfm_tpu_torch`` from another checkout (for
example the parent commit unpacked with ``git archive``), so its kernel
builds under DIR and runs; the inputs always come from this checkout's
``chip_smoke.fit_inputs``.  ``--against`` loads a state saved by an
earlier run and reports, per array, whether the two are bitwise equal and
the largest absolute difference.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

NAMES = ("user_table", "user_acc", "item_table", "item_acc")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--save", required=True)
    p.add_argument("--tree", default=None)
    p.add_argument("--against", default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)  # this checkout's package, unless --tree names another
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        print("torch_k5_compare: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from lightfm_tpu_torch.ops import warp_fit as wf

    print(f"lightfm_tpu_torch from {os.path.dirname(wf.__file__)}", flush=True)
    inp = chip_smoke.fit_inputs(torch, args.seed)
    state = wf.warp_fit_fused(*inp["tables"], inp["batches_t"], inp["negs_t"], inp["positives"],
                              **inp["kw"])
    torch.cuda.synchronize()
    arrays = {k: v.cpu().numpy() for k, v in zip(NAMES, state)}
    np.savez(args.save, **arrays)
    if args.against:
        other = np.load(args.against)
        report = {k: {"bitwise_equal": bool(np.array_equal(arrays[k], other[k])),
                      "max_abs_diff": float(np.abs(arrays[k] - other[k]).max())}
                  for k in NAMES}
        print(json.dumps(report), flush=True)
        return 0 if all(r["bitwise_equal"] for r in report.values()) else 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
