"""Run one cell of the port's benchmark once, on the machine it is started on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``portbench/configs/``), a traffic mix
(``portbench/traffic/``, whose ``driver`` names the module under
``portbench/drivers/`` that runs it) and its limits
(``portbench/limits/<cell>.json``).  ``--trace 0`` measures the cell's
end-to-end metrics over a window of ``--seconds``; ``--trace 1`` runs a
short traced window and reads the cell's per-layer metrics, each with its
reader ``portbench/metrics/<metric>.py``.  Every run then checks what the
timed path produced against the plain reference (``portbench/reference/``)
and prints, last, one JSON line.

The port reads no setting from outside the configuration: every
``LIGHTFM_TPU_*`` variable is removed before it is imported.  Kernel
builds stay in ``lightfm_tpu_torch/_build``; PyTorch's extension and
Triton caches are pointed at ``portbench/.cache``.  Without CUDA, or with
fewer cards than the cell asks for, the run exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import core  # noqa: E402


def _environment():
    for key in [k for k in os.environ if k.startswith("LIGHTFM_TPU_")]:
        del os.environ[key]
    cache = core.BENCH_DIR / ".cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
        os.makedirs(os.environ[var], exist_ok=True)


def _guard(when: str) -> bool:
    found = core.forbidden_modules()
    if found:
        print(f"portbench: {when}, the process holds forbidden modules: {found}", file=sys.stderr)
    return not found


def _device_info(torch, chips: int, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def run(args, cell, driver_module) -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return measure(args, cell, driver_module, torch.device("cuda", 0))


def measure(args, cell, driver_module, device, t_start: float = T_START) -> int:
    """Set-up, window, check and result line of one run on ``device`` (the
    CPU only in the benchmark's own tests)."""
    import torch

    driver = driver_module.Run(cell, args.seed, device)
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    if not _guard("after set-up"):
        return 3

    breakdown = None
    if args.trace:
        ctx = driver.traced()
        ctx["chips"] = cell.chips
        tr = ctx["trace"]
        metrics = {}
        for m in cell.metrics("per_layer"):
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted, failed = ctx.get("fits", ctx.get("requests", 0)), 0
        device = _device_info(torch, cell.chips, device)
        device["busy_s"], device["window_s"] = tr.busy_s, tr.window_s
        breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_by_span(10)}
        print(f"trace: {len(tr.gpu)} device operations, {len(tr.runtime)} launches, "
              f"{len(tr.spans)} spans", file=sys.stderr)
        del ctx, tr
    else:
        out = driver.window(args.seconds)
        attempted, failed = out["attempted"], out["failed"]
        values = dict(out["metrics"], setup_s=setup_s)
        metrics = {}
        for m in cell.metrics("end_to_end"):
            if m["name"] not in values:
                raise RuntimeError(f"the {cell.traffic['driver']} driver gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        device = _device_info(torch, cell.chips, device)
    if not _guard("after the window"):
        return 3

    driver.release()
    numbers = driver.checks()
    missing = sorted(set(cell.limits) - set(numbers))
    if missing:
        raise RuntimeError(f"the check gave no {missing}")
    # The cell's limits file names the numbers it compares.
    checks = {k: {"value": numbers[k], "limit": v} for k, v in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if not _guard("at the end"):
        return 3
    line = core.result_line(correct, attempted, failed, metrics, device, checks, breakdown)
    print(line, flush=True)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr, flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be a non-negative integer")
    _environment()
    cell = core.Cell(args.workload)
    import importlib

    driver_module = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    return run(args, cell, driver_module)


if __name__ == "__main__":
    sys.exit(main())
