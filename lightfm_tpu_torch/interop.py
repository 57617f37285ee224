"""Carry model weights between numpy (or the JAX package) and the port.

A JAX-trained state crosses over as numpy arrays keyed by the eight
``ModelState`` field names::

    arrays = {n: np.asarray(x) for n, x in zip(ModelState._fields, jax_state)}
    state = state_from_numpy(arrays, device="cuda")

The layout is identical in both packages (``[n, W]`` tables, W =
``table_width(D)``, bias in the last column), so no array is reshaped.
"""

from __future__ import annotations

import numpy as np
import torch

from lightfm_tpu_torch.state import ModelState


def state_from_numpy(arrays: dict, device) -> ModelState:
    """ModelState of float32 tensors on ``device`` from a dict of arrays."""
    missing = [n for n in ModelState._fields if n not in arrays]
    if missing:
        raise ValueError(f"state arrays are missing fields {missing}")
    out = {}
    for name in ModelState._fields:
        a = np.asarray(arrays[name], dtype=np.float32)
        if name.endswith("_log_scale") and a.shape != ():
            raise ValueError(f"{name} must be a scalar, got shape {a.shape}")
        out[name] = torch.tensor(a, device=device)
    if out["item_table"].dim() != 2 or out["user_table"].dim() != 2:
        raise ValueError("item_table and user_table must be 2-D")
    return ModelState(**out)


def state_to_numpy(state: ModelState) -> dict:
    """``{field name: float32 numpy array}`` copies of a ModelState."""
    return {
        name: x.detach().cpu().numpy().copy()
        for name, x in zip(ModelState._fields, state)
    }
