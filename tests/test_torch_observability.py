"""The port's ``observability.trace``: a ``torch.profiler`` trace of a
small CPU fit is written as TensorBoard's ``*.pt.trace.json`` and parses;
``device=None`` means CUDA, so it raises on a machine without a GPU."""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lightfm_tpu_torch import LightFM, observability


def _small_interactions():
    rng = np.random.RandomState(0)
    rows = np.repeat(np.arange(40), 5)
    cols = rng.randint(0, 30, rows.size)
    return sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(40, 30))


def test_cpu_trace_of_a_fit_is_written(tmp_path):
    model = LightFM(no_components=4, random_state=2, device="cpu")
    with observability.trace(str(tmp_path), device="cpu") as prof:
        model.fit(_small_interactions(), epochs=1)
    assert isinstance(prof, torch.profiler.profile)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert not any(e.get("cat") == "kernel" for e in events)  # no CUDA activity asked for
    assert model.fit_stats_.wall_s is not None


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default trace would record it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with observability.trace(str(tmp_path)):
            pass
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with observability.trace(str(tmp_path), device="cuda"):
            pass
    assert list(tmp_path.iterdir()) == []
