"""Per-rank training-data ingestion.

Counterpart of ``lightfm_tpu/parallel/ingest.py``.  At scale no rank
should hold the whole interaction set: each rank reads only its data
coordinate's slice of the examples and calls :func:`build_local_train_data`,
which packs that slice into the rank's ``[8, n_pad / n_data]`` column block
of the global padded block.  Pair it with ``example_shuffle="local"`` so the
per-epoch permutation stays on the rank too (``train._shuffle_local_slice``).

In the JAX package a process holds the slice of its devices; here every
rank is a process, and ranks that share a data coordinate (they differ on
the model axis) hold the same slice.

Negative-sampling structures (the per-user positives for WARP/BPR
rejection, BPR's empirical item column) describe the GLOBAL training set.
With more than one data coordinate they MUST be passed in
(``global_positives`` / ``global_train_items``): built from each rank's
slice they would differ between the replicas and the replicas' updates
would part.  A mesh with one data coordinate may omit them, since its
slice is the global set.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lightfm_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, check_mesh


def _pack_local(coo, weights: np.ndarray, n_local_pad: int) -> np.ndarray:
    """Pack one rank's example slice into its [8, n_local_pad] block."""
    n = len(coo.data)
    packed = np.zeros((8, n_local_pad), dtype=np.int32)
    packed[0, :n] = coo.row.astype(np.int32)
    packed[1, :n] = coo.col.astype(np.int32)
    packed[2, :n] = coo.data.astype(np.float32).view(np.int32)
    packed[3, :n] = weights.astype(np.float32).view(np.int32)
    packed[4, :n] = 1
    return packed


def build_local_train_data(
    local_interactions,
    sample_weight_data: Optional[np.ndarray],
    user_feats,
    item_feats,
    hp,
    batch_size: int,
    mesh: Mesh,
    n_examples_global: int,
    global_positives=None,
    global_train_items: Optional[np.ndarray] = None,
):
    """A :class:`~lightfm_tpu_torch.train.TrainData` holding this rank's
    slice of the examples (``examples_sharded=True``), on the mesh's device.

    Parameters
    ----------
    local_interactions : scipy COO [n_users, n_items]
        THIS rank's slice of the training interactions (full matrix shape,
        locally held nonzeros).
    sample_weight_data : float32 [local nnz] or None
    user_feats / item_feats : IdentityRows | PaddedRows
        Feature structures, whole on every rank.
    n_examples_global : int
        Total interaction count over all data coordinates.
    global_positives : scipy CSR, optional
        Global per-user positive items for negative-sample rejection.
    global_train_items : int array, optional
        Global item column for BPR's empirical negative distribution.
    """
    import scipy.sparse as sp

    from lightfm_tpu_torch.train import TrainData, build_positives

    check_mesh(mesh)
    coo = local_interactions.tocoo()
    n_local = len(coo.data)
    if sample_weight_data is None:
        sample_weight_data = np.ones(n_local, dtype=np.float32)

    n_data = mesh.shape[DATA_AXIS]
    # Global pad: a whole number of batches AND an equal slice per data
    # coordinate.
    chunk = int(np.lcm(batch_size, n_data))
    n_pad = max(1, -(-n_examples_global // chunk)) * chunk
    n_local_pad = n_pad // n_data
    if n_local > n_local_pad:
        raise ValueError(
            f"local slice ({n_local}) exceeds its share of the padded global "
            f"block ({n_local_pad}); pass the true global example count"
        )

    dev = mesh.device
    packed = torch.from_numpy(
        _pack_local(coo, np.asarray(sample_weight_data), n_local_pad)
    ).to(dev)

    positives = None
    train_items = None
    if hp.loss in ("warp", "bpr", "warp-kos"):
        if global_positives is None and n_data > 1:
            raise ValueError(
                f"loss='{hp.loss}' needs the GLOBAL per-user positives for "
                "negative-sample rejection; with more than one data coordinate "
                "pass global_positives (a [n_users, n_items] CSR of all training "
                "interactions) -- per-rank slices would give each replica "
                "different positives"
            )
        src = sp.coo_matrix(global_positives if global_positives is not None else coo)
        positives = build_positives(src.row, src.col, src.shape, hp.loss, dev)
    if hp.loss == "bpr":
        if global_train_items is None and n_data > 1:
            raise ValueError(
                "loss='bpr' needs the GLOBAL training item column (its "
                "empirical negative distribution); with more than one data "
                "coordinate pass global_train_items -- per-rank slices would "
                "give each replica a different distribution"
            )
        items = (
            np.asarray(global_train_items, dtype=np.int32)
            if global_train_items is not None
            else coo.col.astype(np.int32)
        )
        train_items = torch.from_numpy(np.ascontiguousarray(items)).to(dev)

    return TrainData(
        packed=packed,
        user_feats=user_feats,
        item_feats=item_feats,
        positives=positives,
        train_items=train_items,
        examples_sharded=True,
    )
