"""Faults planted in the port under a run, to show that the checks catch
them: the benchmark's tests plant each on the CPU, and
``portbench/readings.py`` reads them on the card at a cell's own size.

- ``unchanged``: a training step that returns its state unchanged.
- ``half_batch``: half of every training batch left out.
- ``altered``: one rank answer altered where it is produced.
- ``half_users``: the rank answers of half of the test interactions left
  out (zero).
"""

from __future__ import annotations

import contextlib

from portbench.traced import Patches

FIT_FAULTS = ("unchanged", "half_batch")
EVAL_FAULTS = ("altered", "half_users")


@contextlib.contextmanager
def planted(name: str):
    import torch

    from lightfm_tpu_torch import fast_warp, model

    with Patches() as p:
        if name == "unchanged":
            p.wrap(fast_warp, "warp_pool_step", lambda step: lambda state, *a, **k: state)
        elif name == "half_batch":
            def half(step):
                def inner(state, batch, *a, **k):
                    n = batch.valid.shape[0]
                    keep = torch.arange(n, device=batch.valid.device) < n // 2
                    return step(state, batch._replace(valid=batch.valid & keep), *a, **k)
                return inner
            p.wrap(fast_warp, "warp_pool_step", half)
        elif name in EVAL_FAULTS:
            def wrong(rank):
                def inner(state, user_feats, item_feats, test_csr, *a, **k):
                    out = rank(state, user_feats, item_feats, test_csr, *a, **k)
                    if name == "altered":
                        n = test_csr.shape[1]
                        out[0] = (out[0] + n // 2) % n
                    else:
                        out[len(out) // 2:] = 0
                    return out
                return inner
            p.wrap(model, "predict_ranks_padded", wrong)
        else:
            raise ValueError(f"unknown fault {name!r}")
        yield
