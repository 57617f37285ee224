"""LightFM's documented hybrid model (WARP over item tags with ``item_alpha``
L2, upstream ``hybrid_crossvalidated.rst``) on the port's generic path,
against the benchmark's plain reference ``portbench/reference/warp_generic.py``
on the CPU at a tiny size.

``LightFM.fit`` trains from its seeded random tables off the fast path; its
state before the first step and after each of the first three (tables,
accumulators and both log scales) agrees with the reference's within
``1e-5 + 1e-5 * |x|``: the two sum the same float32 terms in another order
(feature sums, duplicate touches of hot tag rows, the learning-rate
statistics), which moves entries by 5e-6 at most here.  The reference with
its operands rounded to bfloat16, the precision below float32, put in the
program's place fails the same tolerance.  ``item_alpha=1e-6`` is the
source's: there ``1 + alpha * lr_local`` rounds to 1 in float32 and only
the scale bump acts; ``1e-2`` exercises the per-touch multiply too.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lightfm_tpu_torch import LightFM, losses

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from portbench.data import synth, tags as tag_data  # noqa: E402
from portbench.reference import warp_generic  # noqa: E402

FIELDS = ("item_table", "item_acc", "user_table", "user_acc", "item_log_scale",
          "user_log_scale")
D, W, K, LR, B, SEED = 6, 8, 10, 0.05, 512, 11
N_USERS, N_ITEMS = 300, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    coo, _ = synth.clustered_interactions(N_USERS, N_ITEMS, 4000, 5, 4)
    tags = tag_data.item_tags(N_ITEMS, 7, n_tags=96, topic_tags=8, n_clusters=4)
    return coo, tags


def _item_features(tags, layout):
    if layout == "tags":
        return tags
    return sp.hstack([sp.identity(N_ITEMS, np.float32, format="csr"), tags]).tocsr()


def _first_steps_of_fit(model, coo, feats, monkeypatch, steps=3):
    """The fit's state before its first step and after each of its first
    ``steps`` steps, on the CPU."""
    snaps, count = {}, [0]
    step = losses.LOSS_STEPS["warp"]

    def snapshot(state):
        return {k: getattr(state, k).detach().clone() for k in FIELDS}

    def watch(state, *a, **k):
        if count[0] == 0:
            snaps[0] = snapshot(state)
        out = step(state, *a, **k)
        count[0] += 1
        if count[0] <= steps:
            snaps[count[0]] = snapshot(out)
        return out

    monkeypatch.setitem(losses.LOSS_STEPS, "warp", watch)
    model.fit(coo, item_features=feats, epochs=2)
    return snaps


def _worst(prog, ref):
    """The largest ``|prog - ref| - 1e-5 |ref|`` over every field and step."""
    return max(float(((prog[s][k] - ref[s][k]).abs() - 1e-5 * ref[s][k].abs()).max())
               for s in ref for k in FIELDS)


@pytest.mark.parametrize("alpha", [0.0, 1e-6, 1e-2])
@pytest.mark.parametrize("layout", ["tags", "identity+tags"])
def test_generic_hybrid_fit_matches_the_plain_reference(data, layout, alpha, monkeypatch):
    coo, tags = data
    feats = _item_features(tags, layout)
    model = LightFM(loss="warp", no_components=D, item_alpha=alpha, batch_size=B,
                    random_state=SEED, device="cpu")
    prog = _first_steps_of_fit(model, coo, feats, monkeypatch)
    assert model._staged_fast is False
    assert sorted(prog) == [0, 1, 2, 3]

    def reference(rounding):
        return warp_generic.first_steps(
            coo, feats, D=D, W=W, K=K, lr=LR, item_alpha=alpha, user_alpha=0.0,
            batch_size=B, model_seed=SEED, epochs=2, steps=range(4), device="cpu",
            rounding=rounding)

    ref = reference("fp32")
    assert _worst(prog, ref) <= 1e-5
    # The steps moved both tables, and the scale only with L2 on.
    for side in ("item", "user"):
        assert not torch.equal(prog[3][f"{side}_table"], prog[0][f"{side}_table"])
    assert (float(prog[3]["item_log_scale"]) > 0) == (alpha > 0)
    assert float(prog[3]["user_log_scale"]) == 0.0
    # The control: bfloat16 operands in the program's place.
    assert _worst(reference("bf16"), ref) > 1e-5


def test_tag_layout_pads_to_eight_and_stays_off_the_fast_path(data):
    coo, tags = data
    model = LightFM(loss="warp", no_components=30, item_alpha=1e-6, batch_size=B,
                    random_state=SEED, device="cpu", fast_path="on")
    model.fit(coo, item_features=tags, epochs=1)
    assert model._staged_fast is False
    feats = model._staged_train_data.item_feats
    assert feats.idx.shape == (N_ITEMS, 8) and feats.n_cols == tags.shape[1]
    assert model.item_embeddings.shape == (tags.shape[1], 30)
    assert np.isfinite(model.item_embeddings).all()
