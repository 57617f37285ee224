"""Checkpoints: the JAX package's npz format, read and written by the port.

Counterpart of ``lightfm_tpu/checkpoint.py:26-111``.  One ``.npz`` file
holds the eight state arrays, the numpy RandomState and a JSON header with
the hyperparameters, ``FORMAT_VERSION = 2``.  A file written by either
package loads in the other, which is how a server loads a model that the
JAX package trained.
"""

from __future__ import annotations

import json

import numpy as np

from lightfm_tpu_torch.interop import state_from_numpy, state_to_numpy
from lightfm_tpu_torch.state import ModelState

FORMAT_VERSION = 2  # v2: lazy-reg scales stored in log space

_STATE_FIELDS = ModelState._fields


def save_model(model, path: str) -> None:
    """Serialize a LightFM model to ``path`` (.npz).

    A model whose tables are split over a mesh's model axis is assembled
    on the host first, a collective: every rank of the mesh calls
    ``save_model``, and rank 0 alone writes the file.
    """
    model._sync_mirrors()  # fold pending in-place edits of state views
    state = None if model._state is None else model._whole_state()
    split = model._placement is not None and model._placement.sharded
    if split and model._placement.mesh.rank != 0:
        return
    header = {
        "format_version": FORMAT_VERSION,
        "params": {
            k: v
            for k, v in model.get_params().items()
            # random_state is serialized separately; mesh holds device
            # handles; device is the port's own argument, which the JAX
            # package's constructor would reject.
            if k not in ("random_state", "mesh", "device")
        },
        "fitted": model._state is not None,
        # Serving metadata: without these a reloaded hybrid model would
        # bypass recommend()'s feature guards and mis-size its catalog.
        "serving": {
            "n_users_": getattr(model, "n_users_", None),
            "n_items_": getattr(model, "n_items_", None),
            "_item_features_used": getattr(model, "_item_features_used", False),
            "_user_features_used": getattr(model, "_user_features_used", False),
        },
    }
    arrays = {"_header": np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)}

    # numpy RandomState: 5-tuple ('MT19937', keys, pos, has_gauss, cached).
    rs = model.random_state.get_state()
    arrays["_rng_keys"] = rs[1]
    arrays["_rng_meta"] = np.array([rs[2], rs[3], rs[4]], dtype=np.float64)

    if state is not None:
        for name, a in state_to_numpy(state).items():
            arrays[f"state_{name}"] = a
    _write(path, arrays)


def _write(path: str, arrays: dict) -> None:
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_model(path: str, device=None):
    """Load a model saved by either package's ``save_model`` onto
    ``device`` (default CUDA; raises when there is none)."""
    from lightfm_tpu_torch.model import LightFM

    with np.load(path) as z:
        header = json.loads(bytes(z["_header"].tobytes()).decode())
        if header["format_version"] > FORMAT_VERSION:
            raise ValueError(
                "Checkpoint format version {} is newer than supported {}".format(
                    header["format_version"], FORMAT_VERSION
                )
            )
        model = LightFM(**header["params"], device=device)
        rng_keys = z["_rng_keys"]
        pos, has_gauss, cached = z["_rng_meta"]
        model.random_state.set_state(
            ("MT19937", rng_keys, int(pos), int(has_gauss), float(cached))
        )
        if header["fitted"]:
            arrays = {
                name: np.asarray(z[f"state_{name}"])
                for name in _STATE_FIELDS
                if f"state_{name}" in z
            }
            # v1 migration: scales were stored linear; v2 stores log.
            if header["format_version"] < 2:
                for side in ("item", "user"):
                    old = f"state_{side}_scale"
                    if old in z:
                        arrays[f"{side}_log_scale"] = np.log(
                            np.asarray(z[old], dtype=np.float32)
                        )
            missing = [n for n in _STATE_FIELDS if n not in arrays]
            if missing:
                raise ValueError(
                    f"Checkpoint is missing state fields {missing}; it may "
                    "come from an incompatible version."
                )
            model._state = state_from_numpy(arrays, model.device)
            for attr, value in header.get("serving", {}).items():
                if value is not None:
                    setattr(model, attr, value)
    return model
