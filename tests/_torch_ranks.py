"""Launch gloo ranks of the port on the CPU for the multi-device tests.

A test file that uses it runs itself as the ranks' script::

    results = launch(__file__, "scenario", tmp_path, inputs={...})

starts ``world`` processes of ``python <file> --worker scenario --rank r
--world n --port p --dir tmp_path``, each with one torch thread, and
waits for them with a timeout.  Inputs go to the ranks as
``tmp_path/in.npz``; rank r writes ``tmp_path/out_<r>.npz``, returned as
one dict of arrays per rank.  The file's ``__main__`` block calls
:func:`worker` with its scenario functions.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(script: str, scenario: str, tmp_path, inputs=None, world: int = 2,
           timeout: float = 240.0) -> list:
    """Run ``scenario`` of ``script`` on ``world`` gloo ranks; each rank's
    outputs (a dict of arrays).  A rank that fails or outlives ``timeout``
    fails the test with every rank's log."""
    tmp = str(tmp_path)
    np.savez(os.path.join(tmp, "in.npz"), **(inputs or {}))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, script, "--worker", scenario, "--rank", str(r), "--world",
             str(world), "--port", str(port), "--dir", tmp],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(world)
    ]
    logs, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"ranks of {scenario!r} outlived {timeout} s")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {scenario!r} failed:\n{logs[r]}")
    outs = []
    for r in range(world):
        with np.load(os.path.join(tmp, f"out_{r}.npz"), allow_pickle=False) as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def worker(scenarios: dict) -> int:
    """A rank's main: join the gloo group, run the named scenario with the
    inputs, write its outputs, leave the group."""
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--worker", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--dir", required=True)
    a = p.parse_args()
    torch.set_num_threads(1)

    import torch.distributed as dist

    from lightfm_tpu_torch.parallel import initialize_multihost

    initialize_multihost(backend="gloo", init_method=f"tcp://localhost:{a.port}",
                         world_size=a.world, rank=a.rank, timeout_s=120)
    try:
        with np.load(os.path.join(a.dir, "in.npz"), allow_pickle=False) as z:
            inputs = {k: z[k] for k in z.files}
        out = scenarios[a.worker](inputs, a.rank, a.dir)
        np.savez(os.path.join(a.dir, f"out_{a.rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0
