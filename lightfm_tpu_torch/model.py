"""The LightFM-compatible hybrid factorization model.

Counterpart of ``lightfm_tpu/model.py:83-1420``: the constructor,
``fit``/``fit_partial``, ``predict``, ``predict_rank``, ``recommend``,
``get_*_representations``, ``get_params``/``set_params``, pickling and the
twelve reference state arrays as numpy views that user code may edit in
place.  ``fit`` trains every single-device configuration of the JAX
package, on the fast path where it is eligible and on the generic path
otherwise (see :meth:`LightFM.fit_partial`), with optional mid-fit
checkpoints, and over a ``mesh`` (data-parallel, with tables replicated or
split by rows or components over its model axis); a model can also take
its state from a checkpoint
(:func:`lightfm_tpu_torch.load_model`, which reads files the JAX package
writes) or from :mod:`lightfm_tpu_torch.interop`.

``device`` is the one argument the JAX class does not have.  It defaults to
``"cuda"``; without a CUDA device the constructor raises rather than run on
the CPU.  Pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels on the CPU.
"""

from __future__ import annotations

import os
import weakref

import numpy as np
import scipy.sparse as sp
import torch

from lightfm_tpu_torch.config import Hyperparams
from lightfm_tpu_torch.ops.ranking import predict_ranks_padded
from lightfm_tpu_torch.ops.representation import batch_representation, score_pairs
from lightfm_tpu_torch.sparse import PaddedRows, content_fingerprint, identity_rows, pad_csr
from lightfm_tpu_torch.state import ModelState

__all__ = ["LightFM"]

# Module-level memo of the hybrid path's transposed feature structures
# (LightFM._transposed_features): the fat tier is hundreds of MB built from
# the CSR, and a fresh model refit on the same features must not pay it again.
_TRANSPOSE_MEMO: dict = {}

CYTHON_DTYPE = np.float32  # the reference's on-disk dtype; kept for parity

# Public attribute name -> (internal fused array, column view).  The
# reference exposes 12 separate arrays (`lightfm/lightfm.py:243-257`);
# biases live in the LAST column of each width-padded table.
_FIELD_MAP = {
    "item_embeddings": ("item_table", "emb"),
    "item_biases": ("item_table", "bias"),
    "item_embedding_gradients": ("item_acc", "emb"),
    "item_bias_gradients": ("item_acc", "bias"),
    "item_embedding_momentum": ("item_mom", "emb"),
    "item_bias_momentum": ("item_mom", "bias"),
    "user_embeddings": ("user_table", "emb"),
    "user_biases": ("user_table", "bias"),
    "user_embedding_gradients": ("user_acc", "emb"),
    "user_bias_gradients": ("user_acc", "bias"),
    "user_embedding_momentum": ("user_mom", "emb"),
    "user_bias_momentum": ("user_mom", "bias"),
}


def resolve_device(device) -> torch.device:
    """``None`` means CUDA; a CUDA device must exist (no silent CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lightfm_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def _predict_pairs(state: ModelState, user_feats, item_feats, user_ids, item_ids):
    # Lazy-reg scales are folded into the tables at every epoch end, so
    # prediction skips the scale multiply.
    u_rep = batch_representation(state.user_table, user_feats, user_ids)
    i_rep = batch_representation(state.item_table, item_feats, item_ids)
    return score_pairs(u_rep, i_rep)


class LightFM:
    """A hybrid latent representation recommender model (PyTorch / CUDA).

    Semantics follow the reference LightFM: user/item representations are
    the weighted sums of their features' embeddings, scores are their dot
    product plus both biases.
    """

    def __init__(
        self,
        no_components=10,
        k=5,
        n=10,
        learning_schedule="adagrad",
        loss="logistic",
        learning_rate=0.05,
        rho=0.95,
        epsilon=1e-6,
        item_alpha=0.0,
        user_alpha=0.0,
        max_sampled=10,
        random_state=None,
        batch_size=None,
        mesh=None,
        table_partition="replicated",
        shard_examples=False,
        example_shuffle="global",
        fast_path="auto",
        pool_kernels="auto",
        user_pallas=True,
        fast_precision="default",
        shuffle_mode="feistel",
        device=None,
    ):
        # Validation mirrors `lightfm/lightfm.py:205-216`; the rest is
        # delegated to Hyperparams.__post_init__.
        if max_sampled < 1:
            raise ValueError("max_sampled must be a positive integer")
        Hyperparams(
            no_components=no_components,
            k=int(k),
            n=int(n),
            learning_schedule=learning_schedule,
            loss=loss,
            learning_rate=learning_rate,
            rho=rho,
            epsilon=epsilon,
            item_alpha=item_alpha,
            user_alpha=user_alpha,
            max_sampled=max_sampled,
            batch_size=batch_size,
            fast_path=fast_path,
            pool_kernels=pool_kernels,
            user_pallas=user_pallas,
            fast_precision=fast_precision,
            shuffle_mode=shuffle_mode,
        )
        if example_shuffle not in ("global", "local"):
            raise ValueError("example_shuffle must be 'global' or 'local'")
        if example_shuffle == "local" and mesh is None:
            raise ValueError("example_shuffle='local' requires a mesh")

        self.loss = loss
        self.learning_schedule = learning_schedule
        self.no_components = no_components
        self.learning_rate = learning_rate
        self.k = int(k)
        self.n = int(n)
        self.rho = rho
        self.epsilon = epsilon
        self.max_sampled = max_sampled
        self.item_alpha = item_alpha
        self.user_alpha = user_alpha
        self.batch_size = batch_size
        self.fast_path = fast_path
        self.pool_kernels = pool_kernels
        self.user_pallas = user_pallas
        self.fast_precision = fast_precision
        self.shuffle_mode = shuffle_mode
        # A lightfm_tpu_torch.parallel.Mesh: data-parallel training, tables
        # placed by table_partition, and recommend() through top_k_sharded.
        self.mesh = mesh
        self.table_partition = table_partition
        self.shard_examples = shard_examples
        self.example_shuffle = example_shuffle

        if random_state is None:
            self.random_state = np.random.RandomState()
        elif isinstance(random_state, np.random.RandomState):
            self.random_state = random_state
        else:
            self.random_state = np.random.RandomState(random_state)

        self._device = resolve_device(device)
        self._reset_state()

    @property
    def device(self) -> str:
        return str(self._device)

    @device.setter
    def device(self, value):
        self._sync_mirrors()
        self._device = resolve_device(value)
        if self._state is not None:
            self._state = ModelState(*(x.to(self._device) for x in self._state))
        self._drop_mirrors()
        self._serving_cache = {}
        self._assembled = None

    # ------------------------------------------------------------------
    # State plumbing
    # ------------------------------------------------------------------

    def _reset_state(self):
        self._state: ModelState | None = None
        # Where a mesh fit placed the state (parallel.mesh.Placement; None:
        # whole tensors), and under a row or component partition the whole
        # state assembled for serving (dropped whenever the state changes).
        self._placement = None
        self._assembled = None
        # recommend()'s catalog / compressed index and the identity-keyed
        # host prep of the input matrices.
        self._serving_cache: dict = {}
        # Writable host mirrors of the fused state tables, handed out (as
        # views) by the state-attribute getters so user code can edit them
        # in place like the reference's numpy attributes; `_mirror_snaps`
        # holds pristine copies used to detect edits (`_sync_mirrors`).
        self._host_mirrors: dict = {}
        self._mirror_snaps: dict = {}

    def _hp(self, bpr_tries: int = 8) -> Hyperparams:
        return Hyperparams(
            no_components=self.no_components,
            k=int(self.k),
            n=int(self.n),
            learning_schedule=self.learning_schedule,
            loss=self.loss,
            learning_rate=self.learning_rate,
            rho=self.rho,
            epsilon=self.epsilon,
            item_alpha=self.item_alpha,
            user_alpha=self.user_alpha,
            max_sampled=self.max_sampled,
            batch_size=self.batch_size,
            bpr_tries=bpr_tries,
            fast_path=self.fast_path,
            pool_kernels=self.pool_kernels,
            user_pallas=self.user_pallas,
            fast_precision=self.fast_precision,
            shuffle_mode=self.shuffle_mode,
        )

    @staticmethod
    def _bpr_tries_for(interactions) -> int:
        """Rejection-draw budget for BPR's empirical negative sampling
        (``lightfm_tpu/model.py:229-257``): sized so the user whose
        positives carry the most empirical mass falls through < 1e-3 of the
        time, a power of two in [8, 64]."""
        nnz = interactions.nnz
        if nnz == 0:
            return 8
        csr = sp.csr_matrix(interactions)
        item_counts = np.asarray(csr.getnnz(axis=0), dtype=np.float64).ravel()
        indicator = csr.copy()
        indicator.data = np.ones_like(indicator.data)
        user_mass = indicator.dot(item_counts)
        p = min(float(user_mass.max(initial=0.0)) / nnz, 0.99)
        if p <= 0:
            return 8
        need = int(np.ceil(np.log(1e-3) / np.log(p))) if p > 1e-3 else 1
        return int(min(64, max(8, 1 << (max(need, 1) - 1).bit_length())))

    def _process_sample_weight(self, interactions, sample_weight):
        if sample_weight is not None:
            if self.loss == "warp-kos":
                raise NotImplementedError("k-OS loss with sample weights not implemented.")
            if not isinstance(sample_weight, sp.coo_matrix):
                raise ValueError("Sample_weight must be a COO matrix.")
            if sample_weight.shape != interactions.shape:
                raise ValueError(
                    "Sample weight and interactions matrices must be the same shape"
                )
            if not (
                np.array_equal(interactions.row, sample_weight.row)
                and np.array_equal(interactions.col, sample_weight.col)
            ):
                raise ValueError(
                    "Sample weight and interaction matrix "
                    "entries must be in the same order"
                )
            if sample_weight.data.dtype != CYTHON_DTYPE:
                return sample_weight.data.astype(CYTHON_DTYPE)
            return sample_weight.data
        if np.array_equiv(interactions.data, 1.0):
            return interactions.data
        return np.ones_like(interactions.data, dtype=CYTHON_DTYPE)

    def _check_finite(self):
        """Raise when a table's sum is not finite.  Under a row or component
        partition each rank sums its own part and the flags are summed over
        the model axis, so every rank raises or none does."""
        bad = sum(~torch.isfinite(t.sum()) for t in (self._state.item_table,
                                                   self._state.user_table)).float()
        p = self._placement
        if p is not None and p.sharded:
            from lightfm_tpu_torch.parallel.mesh import sum_over_model

            (bad,) = sum_over_model(p.mesh, bad)
        if bad.item():
            raise ValueError(
                    "Not all estimated parameters are finite,"
                    " your model may have diverged. Try decreasing"
                    " the learning rate or normalising feature values"
                    " and sample weights"
                )

    @staticmethod
    def _check_input_finite(data):
        if not np.isfinite(np.sum(data)):
            raise ValueError(
                "Not all input values are finite. "
                "Check the input for NaNs and infinite values."
            )

    @staticmethod
    def _progress(n, verbose):
        if not verbose:
            return range(n)
        try:
            from tqdm import trange

            return trange(n, desc="Epoch")
        except ImportError:

            def verbose_range():
                for i in range(n):
                    print("Epoch {}".format(i))
                    yield i

            return verbose_range()

    def fit(
        self,
        interactions,
        user_features=None,
        item_features=None,
        sample_weight=None,
        epochs=1,
        num_threads=1,
        verbose=False,
        checkpoint_every_n_epochs=None,
        checkpoint_path=None,
    ):
        """Fit the model, discarding any previously learned state."""
        self._reset_state()
        return self.fit_partial(
            interactions,
            user_features=user_features,
            item_features=item_features,
            sample_weight=sample_weight,
            epochs=epochs,
            num_threads=num_threads,
            verbose=verbose,
            checkpoint_every_n_epochs=checkpoint_every_n_epochs,
            checkpoint_path=checkpoint_path,
        )

    def fit_partial(
        self,
        interactions,
        user_features=None,
        item_features=None,
        sample_weight=None,
        epochs=1,
        num_threads=1,
        verbose=False,
        checkpoint_every_n_epochs=None,
        checkpoint_path=None,
    ):
        """Fit the model, resuming from the current state if already fitted.

        Trains on the fast path (:mod:`lightfm_tpu_torch.fast_warp`) where
        ``fast_warp_eligible`` admits the configuration: loss ``warp``,
        ``bpr`` or ``logistic``, adagrad, no L2, an item table of at least
        2^19 elements (feature count x padded width), ``fast_path="on"`` or
        ``"auto"`` on a CUDA device; identity features, or for ``warp`` and
        ``bpr`` feature matrices of at most ``MAX_FAST_FEAT_NNZ`` = 16
        padded entries per row.  Every other configuration trains on the
        generic path (:func:`lightfm_tpu_torch.train.generic_epoch`): all
        four losses, adagrad and adadelta, ``item_alpha``/``user_alpha``,
        identity, padded and chunked features.  Every epoch draws one seed
        from ``random_state``, which seeds that epoch's ``torch.Generator``.

        With a ``mesh`` (:func:`lightfm_tpu_torch.parallel.make_mesh`) every
        rank calls ``fit`` with the same arguments.  The model's device must
        be the mesh's (``ValueError`` otherwise; the default ``"cuda"``
        takes the mesh's card), and the state takes rank 0's values
        (``shard_state``), every
        rank takes rank 0's epoch seeds (each rank's ``random_state`` still
        advances as without a mesh), and each rank computes its slice of
        every batch, then applies the whole batch's update, so the replicas
        stay bitwise equal: on the fast path where it is eligible
        (replicated tables and examples, identity features), else on the
        generic path, with ``shard_examples`` and ``example_shuffle="local"``.
        ``table_partition="rows"`` or ``"components"`` (or an ``"auto"``
        that resolves to rows) splits the tables over the model axis
        (:func:`lightfm_tpu_torch.parallel.mesh.plan_placement`) and trains
        on the generic path: each step gathers the rows it reads and each
        rank updates the part it holds; no card holds the whole state,
        which stays split after the fit.  The state attributes, the
        representations, pickling and checkpoints then read the whole
        state assembled on the host, and ``predict``, ``predict_rank`` and
        the metrics and ``recommend`` the two whole tables assembled on the
        card: these are collectives that every rank of the mesh calls.
        Checkpoints are written by rank 0 alone.

        ``checkpoint_every_n_epochs``/``checkpoint_path``: when set, the
        model is saved atomically (``save_model`` to a temp file, then
        ``os.replace``) every N epochs and at the fit's end.  Seeds are
        drawn per chunk and the checkpoint keeps the ``RandomState`` at the
        chunk boundary, so ``load_model(path).fit_partial`` for the
        remaining epochs, at the same cadence, continues bit-exactly the
        run that was cut (``lightfm_tpu/model.py:924-971``).
        """
        if checkpoint_every_n_epochs is not None:
            if int(checkpoint_every_n_epochs) < 1:
                raise ValueError("checkpoint_every_n_epochs must be >= 1")
            if not checkpoint_path:
                raise ValueError(
                    "checkpoint_path is required when checkpoint_every_n_epochs is set"
                )
        mesh = self.mesh
        if mesh is not None:
            from lightfm_tpu_torch.parallel.mesh import (
                check_mesh, place_state, plan_placement, shard_train_data)

            check_mesh(mesh)
            own, rank_dev = self._device, mesh.device
            if own.type != rank_dev.type or own.index not in (None, rank_dev.index):
                raise ValueError(
                    f"the model's device ({own}) is not the mesh's ({rank_dev}): build the "
                    "mesh with make_mesh(device=...) or the model with device=None"
                )
            if own != rank_dev:  # "cuda" names no card; the mesh gives its index
                self.device = rank_dev
        from lightfm_tpu_torch.fast_warp import apply_env_overrides, fast_warp_eligible
        from lightfm_tpu_torch.observability import FitStats
        from lightfm_tpu_torch.state import init_state, table_width
        from lightfm_tpu_torch.train import (
            build_train_data,
            choose_batch_size,
            run_epoch,
            run_epochs,
        )

        # Fold pending in-place edits of handed-out state views first.
        self._sync_mirrors()
        self._assembled = None
        interactions = interactions.tocoo()
        if interactions.dtype != CYTHON_DTYPE:
            interactions.data = interactions.data.astype(CYTHON_DTYPE)

        sample_weight_data = self._process_sample_weight(interactions, sample_weight)

        n_users, n_items = interactions.shape
        (user_features, item_features) = self._construct_feature_matrices(
            n_users, n_items, user_features, item_features
        )

        for input_data in (
            user_features.data,
            item_features.data,
            interactions.data,
            sample_weight_data,
        ):
            self._check_input_finite(input_data)

        if self._state is not None:
            if not item_features.shape[1] == self._table_shape("item")[0]:
                raise ValueError("Incorrect number of features in item_features")
            if not user_features.shape[1] == self._table_shape("user")[0]:
                raise ValueError("Incorrect number of features in user_features")
        if num_threads < 1:
            raise ValueError("Number of threads must be 1 or larger.")

        hp = apply_env_overrides(
            self._hp(bpr_tries=self._bpr_tries_for(interactions) if self.loss == "bpr" else 8)
        )
        batch_size = choose_batch_size(len(interactions.data), self.batch_size)
        data = build_train_data(
            interactions,
            np.asarray(sample_weight_data),
            self._pad_features(user_features),
            self._pad_features(item_features),
            hp,
            batch_size,
            self._device,
        )
        W = table_width(self.no_components)
        shapes = ((item_features.shape[1], W), (user_features.shape[1], W))
        table_partition = self._resolve_table_partition(shapes)
        placement = None if mesh is None else plan_placement(mesh, table_partition, *shapes)
        if self._state is None:
            # Under a mesh every rank draws rank 0's tables and keeps its part.
            self._state = init_state(
                self.no_components,
                item_features.shape[1],
                user_features.shape[1],
                self.random_state,
                adagrad=(self.learning_schedule == "adagrad"),
                device=self._device,
                **({} if mesh is None else dict(share_seed=self._rank0_seed,
                                                part=placement.part)),
            )
        elif mesh is not None:
            self._state = place_state(self._state, placement, self._placement)
        elif self._placement is not None:  # a mesh fit before this one
            self._state = ModelState(*(x.to(self._device) for x in self._whole_state()))
        self._placement = placement
        if mesh is not None:
            data = shard_train_data(data, mesh, self.shard_examples)
        fast = fast_warp_eligible(hp, data, mesh, self.example_shuffle, batch_size,
                                  table_partition=table_partition,
                                  shard_examples=self.shard_examples)
        if fast and hp.loss in ("warp", "bpr"):
            # Hybrid aggregated update: stage the TRANSPOSED feature lists
            # so feature-table updates run scatter-free; None for identity
            # sides or when the dense per-step streams would outgrow the
            # batch-proportional budget.
            data = data._replace(
                user_feats_T=self._transposed_features(
                    user_features, data.user_feats, batch_size, hp.fast_precision
                ),
                item_feats_T=self._transposed_features(
                    item_features, data.item_feats, batch_size, hp.fast_precision
                ),
            )

        # Remembered for serving defaults (recommend's catalog size).
        self.n_users_, self.n_items_ = n_users, n_items
        self._item_features_used = not self._is_identity(item_features)
        self._user_features_used = not self._is_identity(user_features)

        # The staged device-resident training set, so callers (tests,
        # benchmarks) can run epochs again without the host prep.
        self._staged_train_data = data
        self._staged_hp = hp
        self._staged_batch_size = batch_size
        self._staged_fast = fast

        stats = FitStats(n_examples=len(interactions.data), epochs=epochs)
        # One seed per epoch from the numpy RandomState, whatever the
        # dispatch granularity (the reference's random-state contract).
        # With checkpoints they are drawn per chunk: the checkpoint keeps
        # the RandomState at the boundary, so a resumed run's remaining
        # chunks draw exactly the seeds an uninterrupted run would.
        chunk = epochs if checkpoint_every_n_epochs is None else int(checkpoint_every_n_epochs)
        progress = iter(self._progress(epochs, verbose=verbose)) if verbose else None
        done = 0
        while done < epochs:
            n = min(chunk, epochs - done)
            seeds = self.random_state.randint(0, np.iinfo(np.int32).max, size=n).astype(np.uint32)
            if mesh is not None:
                seeds = self._rank0_seeds(seeds)
            epoch_kw = dict(fast=fast, mesh=mesh, shuffle=self.example_shuffle,
                            placement=self._placement)
            if verbose:
                # Epoch by epoch, so progress and finite checks track epochs.
                for seed in seeds:
                    next(progress, None)
                    self._state = run_epoch(self._state, data, int(seed), hp, batch_size,
                                            **epoch_kw)
                    self._check_finite()
            else:
                self._state = run_epochs(self._state, data, seeds, hp, batch_size, **epoch_kw)
                self._check_finite()
            self._assembled = None
            done += n
            if checkpoint_every_n_epochs is not None:
                self._save_checkpoint(checkpoint_path)

        self.fit_stats_ = stats.finish()
        # Outstanding host mirrors are snapshots of the pre-fit state.
        self._drop_mirrors()
        self._drop_state_dependent_cache()
        return self

    def _rank0_seeds(self, seeds: np.ndarray) -> np.ndarray:
        """Rank 0's epoch seeds on every rank of the mesh, so every rank
        draws the same epochs whatever its own ``random_state`` holds."""
        from lightfm_tpu_torch.parallel.mesh import broadcast_from_rank0

        t = torch.from_numpy(seeds.astype(np.int64)).to(self.mesh.device)
        return broadcast_from_rank0(self.mesh, t)[0].cpu().numpy().astype(np.uint32)

    def _rank0_seed(self, seed: int) -> int:
        """Rank 0's initialisation seed on every rank of the mesh."""
        return int(self._rank0_seeds(np.array([seed]))[0])

    def _resolve_table_partition(self, shapes=None):
        """Resolve ``table_partition="auto"`` at fit time
        (``lightfm_tpu/model.py:434-486``): replicated while the whole state
        (tables and optimizer accumulators, however it is placed now) fits
        the per-device budget, else rows.  ``shapes``: the whole
        ``(rows, width)`` of the item and user tables (by default the
        state's).

        Budget: ``LIGHTFM_TPU_REPLICATED_TABLE_BUDGET`` (bytes) when set,
        else half the CUDA device's memory, else 4 GiB.
        """
        if self.table_partition != "auto":
            return self.table_partition
        if shapes is None and self._state is not None:
            shapes = (self._table_shape("item"), self._table_shape("user"))
        if self.mesh is None or shapes is None:
            return "replicated"
        raw = os.environ.get("LIGHTFM_TPU_REPLICATED_TABLE_BUDGET")
        if raw:
            budget = int(raw)
        elif self._device.type == "cuda":
            budget = torch.cuda.mem_get_info(self._device)[1] // 2
        else:
            budget = 4 << 30
        # f32 throughout: table, acc and mom of each side, and two scalars.
        state_bytes = 4 * (3 * sum(r * w for r, w in shapes) + 2)
        if state_bytes <= budget:
            return "replicated"
        if self.mesh.shape["model"] <= 1:
            import warnings

            warnings.warn(
                f"table_partition='auto': model state ({state_bytes >> 20} "
                f"MiB) exceeds the per-device replication budget "
                f"({budget >> 20} MiB), but the mesh's 'model' axis has "
                "size 1, so row-sharding cannot reduce per-device memory. "
                "Build the mesh with n_model > 1 for capacity scaling.",
                stacklevel=3,
            )
        return "rows"

    def _save_checkpoint(self, path):
        """Atomic mid-fit checkpoint: write to a temp file, then rename, so
        a kill during the write never leaves a truncated checkpoint.  Under
        a mesh rank 0 writes it (the replicas are equal) and every rank
        waits until it is there.  A split state is assembled on the host
        first, a collective: every rank calls ``save_model``, which writes
        on rank 0 alone."""
        from lightfm_tpu_torch.checkpoint import save_model

        writer = self.mesh is None or self.mesh.rank == 0
        tmp = f"{path}.tmp"
        if writer or self._split():
            save_model(self, tmp)
        if writer:
            os.replace(tmp, path)
        if self.mesh is not None:
            from lightfm_tpu_torch.parallel.mesh import barrier

            barrier(self.mesh)

    def _check_initialized(self):
        if self._state is None:
            raise ValueError(
                "You must fit the model before trying to obtain predictions."
            )
        self._sync_mirrors()

    def _table_shape(self, side: str) -> tuple:
        """The whole ``(rows, width)`` of a side's table, however placed."""
        from lightfm_tpu_torch.parallel.mesh import whole_shape

        name = f"{side}_table"
        return whole_shape(name, getattr(self._state, name), self._placement)

    def _split(self) -> bool:
        return self._placement is not None and self._placement.sharded

    def _whole_field(self, attr: str) -> torch.Tensor:
        """One whole state field: the tensor itself, or under a row or
        component partition its parts assembled on the host (a collective:
        every rank of the mesh calls it)."""
        if not self._split():
            return getattr(self._state, attr)
        from lightfm_tpu_torch.parallel.mesh import assemble

        return assemble(self._state, self._placement, (attr,), device="cpu")[attr]

    def _whole_state(self) -> ModelState:
        """The whole state: ``_state`` itself, or under a row or component
        partition its parts assembled on the host (a collective: every rank
        of the mesh calls it), for checkpoints and pickles."""
        if not self._split():
            return self._state
        from lightfm_tpu_torch.parallel.mesh import assemble_state

        return assemble_state(self._state, self._placement, device="cpu")

    def _serving_state(self) -> ModelState:
        """The state that serving reads: ``_state`` itself, or under a row
        or component partition the two whole tables assembled on the card
        (a collective: every rank of the mesh calls it), kept until the
        state changes.  The optimizer fields stay this rank's parts, which
        serving never reads."""
        if not self._split():
            return self._state
        if self._assembled is None:
            from lightfm_tpu_torch.parallel.mesh import assemble

            self._assembled = self._state._replace(
                **assemble(self._state, self._placement, ("item_table", "user_table")))
        return self._assembled

    def _put_whole(self, attr: str, whole: torch.Tensor):
        """Replace a state field by a whole tensor: this rank keeps its part."""
        part = whole if self._placement is None else self._placement.part(attr, whole)
        self._state = self._state._replace(**{attr: part.to(self._device)})
        self._assembled = None

    def _mirror(self, attr):
        m = self._host_mirrors.get(attr)
        if m is None:
            m = self._whole_field(attr).detach().cpu().numpy().copy()
            self._host_mirrors[attr] = m
            self._mirror_snaps[attr] = m.copy()
        return m

    def _drop_mirrors(self):
        self._host_mirrors = {}
        self._mirror_snaps = {}

    def _sync_mirrors(self):
        """Push in-place edits of handed-out state views back to the device
        (bytewise snapshot compare, at every state-consuming call)."""
        mirrors = getattr(self, "_host_mirrors", None)
        if not mirrors or self._state is None:
            return
        for attr, m in mirrors.items():
            if np.array_equal(m, self._mirror_snaps[attr]):
                continue
            self._put_whole(attr, torch.from_numpy(m.copy()))
            self._mirror_snaps[attr] = m.copy()
            self._drop_state_dependent_cache()  # representations changed

    def _drop_state_dependent_cache(self):
        """Drop serving-cache entries derived from MODEL STATE (catalog,
        compressed index) and the assembled state, keeping the
        identity-keyed host prep."""
        self._assembled = None
        self._serving_cache = {
            k: v
            for k, v in self._serving_cache.items()
            if not (isinstance(k, tuple) and k and k[0] in ("index", "catalog"))
        }

    def _get_field(self, name):
        if self._state is None:
            return None
        attr, kind = _FIELD_MAP[name]
        arr = self._mirror(attr)
        # Layout: [emb cols 0..D-1 | zero pad | bias col W-1].
        return arr[:, : self.no_components] if kind == "emb" else arr[:, -1]

    def _set_field(self, name, value):
        if value is None:
            return
        if self._state is None:
            raise ValueError("Cannot set model state before the model is fitted.")
        # Fold pending in-place edits first so assignment to one field does
        # not discard edits made through another field's view.
        self._sync_mirrors()
        attr, kind = _FIELD_MAP[name]
        table = self._whole_field(attr).clone()
        value = torch.tensor(np.asarray(value, dtype=np.float32), device=table.device)
        if kind == "emb":
            table[:, : self.no_components] = value
        else:
            table[:, -1] = value
        self._put_whole(attr, table)
        self._host_mirrors.pop(attr, None)
        self._mirror_snaps.pop(attr, None)
        self._serving_cache = {}

    # ------------------------------------------------------------------
    # Input coercion / validation (mirrors lightfm.py:314-472)
    # ------------------------------------------------------------------

    def _construct_feature_matrices(self, n_users, n_items, user_features, item_features):
        if user_features is None:
            user_features = sp.identity(n_users, dtype=CYTHON_DTYPE, format="csr")
        else:
            user_features = user_features.tocsr()

        if item_features is None:
            item_features = sp.identity(n_items, dtype=CYTHON_DTYPE, format="csr")
        else:
            item_features = item_features.tocsr()

        if n_users > user_features.shape[0]:
            raise Exception(
                "Number of user feature rows does not equal the number of users"
            )
        if n_items > item_features.shape[0]:
            raise Exception(
                "Number of item feature rows does not equal the number of items"
            )

        if self._state is not None:
            n_user_rows, n_item_rows = self._table_shape("user")[0], self._table_shape("item")[0]
            if not n_user_rows >= user_features.shape[1]:
                raise ValueError(
                    "The user feature matrix specifies more "
                    "features than there are estimated "
                    "feature embeddings: {} vs {}.".format(
                        n_user_rows, user_features.shape[1]
                    )
                )
            if not n_item_rows >= item_features.shape[1]:
                raise ValueError(
                    "The item feature matrix specifies more "
                    "features than there are estimated "
                    "feature embeddings: {} vs {}.".format(
                        n_item_rows, item_features.shape[1]
                    )
                )

        if user_features.dtype != CYTHON_DTYPE:
            user_features = user_features.astype(CYTHON_DTYPE)
        if item_features.dtype != CYTHON_DTYPE:
            item_features = item_features.astype(CYTHON_DTYPE)

        return user_features, item_features

    @staticmethod
    def _is_identity(csr) -> bool:
        n, m = csr.shape
        if n != m or csr.nnz != n:
            return False
        return (
            np.array_equal(csr.indptr, np.arange(n + 1))
            and np.array_equal(csr.indices, np.arange(n))
            and np.all(csr.data == 1.0)
        )

    def _pad_features(self, csr):
        if self._is_identity(csr):
            return identity_rows(csr.shape[0])
        # The width cap bounds padding on skewed data: when the heaviest
        # row is far wider than the 99th percentile, its tail spills into
        # ChunkedRows overflow chunks (exact either way).
        lengths = np.diff(sp.csr_matrix(csr).indptr)
        if len(lengths):
            p99 = int(np.percentile(lengths, 99))
            cap = max(8 * ((p99 + 7) // 8), 8)
            if int(lengths.max()) > max(4 * cap, 64):
                return pad_csr(csr, pad_multiple=8, width_cap=cap, device=self._device)
        return pad_csr(csr, pad_multiple=8, device=self._device)

    def _transposed_features(self, csr, padded, batch_size, fast_precision):
        """Transposed feature lists for the aggregated hybrid update
        (``lightfm_tpu/model.py:309-354``), or None when it should not
        engage: identity features, or entity + feature counts so large
        that the dense per-step table streams would dominate the batch work.
        Memoized module-wide by the feature matrix's identity, content,
        precision and device, so refitting a fresh model on the same
        features does not build the fat tier again."""
        if not isinstance(padded, PaddedRows):
            return None
        if padded.n_rows + padded.n_cols > 32 * batch_size:
            return None
        key = (f"feats_T_{fast_precision}", str(self._device), id(csr),
               content_fingerprint(csr))
        hit = _TRANSPOSE_MEMO.get(key)
        if hit is not None:
            ref, val = hit
            if ref() is csr:
                return val
        val = self._build_transposed(csr, fast_precision)
        try:
            # Sweep dead entries first (a collected matrix must not keep
            # hundreds of MB of device tensors alive), then bound the rest.
            for k in [k for k, (r, _) in _TRANSPOSE_MEMO.items() if r() is None]:
                _TRANSPOSE_MEMO.pop(k, None)
            if len(_TRANSPOSE_MEMO) >= 4:  # bounded: drop the oldest
                _TRANSPOSE_MEMO.pop(next(iter(_TRANSPOSE_MEMO)))
            _TRANSPOSE_MEMO[key] = (weakref.ref(csr), val)
        except TypeError:
            pass
        return val

    @property
    def _FAT_TIER_LIMIT_BYTES(self):
        """Dense fat-tier budget across ``fat_w`` and ``fat_w2``:
        ``LIGHTFM_TPU_FAT_TIER_BYTES``, default 1.5 GiB."""
        return int(os.environ.get("LIGHTFM_TPU_FAT_TIER_BYTES", 1536 << 20))

    def _build_transposed(self, csr, fast_precision):
        """:class:`~lightfm_tpu_torch.fast_warp.TransposedFeats` of ``csr``
        (``lightfm_tpu/model.py:368-432``): transposed rows longer than 8
        become the dense fat tier, the rest the thin padded tier.  None when
        the fat tier is over budget (then updates run as scatters)."""
        from lightfm_tpu_torch.fast_warp import TransposedFeats

        csr_t = sp.csr_matrix(csr).T.tocsr()
        lengths = np.diff(csr_t.indptr)
        fat = np.flatnonzero(lengths > 8)
        limit = self._FAT_TIER_LIMIT_BYTES
        if not len(fat):
            return TransposedFeats(
                thin=pad_csr(csr_t, pad_multiple=1, device=self._device),
                fat_rows=None, fat_w=None, fat_w2=None,
            )
        # Budget, stage 1 (before paying todense): even the best case, one
        # shared bf16 matrix, is over.
        if len(fat) * csr_t.shape[1] * 2 > limit:
            return None
        keep = np.ones(csr_t.shape[0], np.float32)
        keep[fat] = 0.0
        thin_csr = sp.diags(keep).dot(csr_t).tocsr()
        thin_csr.eliminate_zeros()
        dense = torch.from_numpy(np.asarray(csr_t[fat].todense(), dtype=np.float32))
        dense = dense.to(self._device)  # the checks below run on the device
        sq = dense * dense
        # bf16 storage only when both matrices round-trip exactly (the
        # binary-weight case): the scatter path it replaces keeps f32 data.
        bf16_ok = (
            fast_precision == "default"
            and torch.equal(dense.bfloat16().float(), dense)
            and torch.equal(sq.bfloat16().float(), sq)
        )
        dt = torch.bfloat16 if bf16_ok else torch.float32
        shared = torch.equal(sq, dense)
        # Budget, stage 2: the actual bytes, dtype and sharing known.
        if (1 if shared else 2) * dense.numel() * (2 if bf16_ok else 4) > limit:
            return None
        fat_w = dense.to(dt)
        fat_w2 = fat_w if shared else sq.to(dt)
        return TransposedFeats(
            thin=pad_csr(thin_csr, pad_multiple=1, device=self._device),
            fat_rows=torch.from_numpy(fat.astype(np.int32)).to(self._device),
            fat_w=fat_w,
            fat_w2=fat_w2,
        )

    def _memo_by_identity(self, kind: str, obj, build):
        """Memoize ``build(obj)`` in the serving cache keyed by ``obj``'s
        identity (weakref-guarded against id reuse) plus a content checksum
        (in-place mutation misses instead of returning stale results), so
        the per-epoch metric loop skips host padding and staging."""
        key = (kind, id(obj), content_fingerprint(obj))
        hit = self._serving_cache.get(key)
        if hit is not None:
            ref, val = hit
            if ref() is obj:
                return val
        val = build(obj)
        if val is obj:
            # Nothing to memoize; caching would make the entry immortal.
            return val
        try:
            entry = (weakref.ref(obj), val)
        except TypeError:  # non-weakref-able input; skip caching
            return val
        # Evict same-identity entries with a stale checksum, then entries
        # whose input is gone.
        for k, v in list(self._serving_cache.items()):
            stale_same = (
                isinstance(k, tuple) and len(k) == 3
                and k[:2] == key[:2] and k != key
            )
            dead = (
                isinstance(v, tuple)
                and v
                and isinstance(v[0], weakref.ref)
                and v[0]() is None
            )
            if stale_same or dead:
                del self._serving_cache[k]
        self._serving_cache[key] = entry
        # Hard cap for callers that stream fresh live matrices.
        live = [
            k
            for k, v in self._serving_cache.items()
            if isinstance(v, tuple) and v and isinstance(v[0], weakref.ref)
        ]
        for k in live[: max(0, len(live) - 64)]:
            del self._serving_cache[k]
        return val

    def _pad_features_cached(self, csr):
        if self._is_identity(csr):
            # Identity matrices are rebuilt each call; key by shape.
            return self._serving_cache.setdefault(
                ("pad_feats_id", csr.shape[0]), identity_rows(csr.shape[0])
            )
        return self._memo_by_identity("pad_feats", csr, self._pad_features)

    # ------------------------------------------------------------------
    # Prediction
    # ------------------------------------------------------------------

    def predict(
        self, user_ids, item_ids, item_features=None, user_features=None, num_threads=1
    ):
        """Compute the recommendation score for user-item pairs."""
        self._check_initialized()

        if isinstance(user_ids, int) or (
            isinstance(user_ids, np.integer) and np.ndim(user_ids) == 0
        ):
            user_ids = np.repeat(np.int32(user_ids), len(item_ids))
        if isinstance(user_ids, (list, tuple)):
            user_ids = np.array(user_ids, dtype=np.int32)
        if isinstance(item_ids, (list, tuple)):
            item_ids = np.array(item_ids, dtype=np.int32)

        if len(user_ids) != len(item_ids):
            raise ValueError(
                f"Expected the number of user IDs ({len(user_ids)}) to equal the number"
                f" of item IDs ({len(item_ids)})"
            )

        user_ids = np.asarray(user_ids, dtype=np.int32)
        item_ids = np.asarray(item_ids, dtype=np.int32)

        if num_threads < 1:
            raise ValueError("Number of threads must be 1 or larger.")

        if len(user_ids) and (user_ids.min() < 0 or item_ids.min() < 0):
            raise ValueError(
                "User or item ids cannot be negative. "
                "Check your inputs for negative numbers "
                "or very large numbers that can overflow."
            )

        n_users = user_ids.max() + 1
        n_items = item_ids.max() + 1

        (user_features, item_features) = self._construct_feature_matrices(
            n_users, n_items, user_features, item_features
        )

        scores = _predict_pairs(
            self._serving_state(),
            self._pad_features_cached(user_features),
            self._pad_features_cached(item_features),
            torch.from_numpy(user_ids).to(self._device),
            torch.from_numpy(item_ids).to(self._device),
        )
        return scores.cpu().numpy().astype(np.float32, copy=False)

    def _check_test_train_intersections(self, test_mat, train_mat):
        if train_mat is not None:
            n_intersections = test_mat.multiply(train_mat).nnz
            if n_intersections:
                raise ValueError(
                    "Test interactions matrix and train interactions "
                    "matrix share %d interactions. This will cause "
                    "incorrect evaluation, check your data split." % n_intersections
                )

    def predict_rank(
        self,
        test_interactions,
        train_interactions=None,
        item_features=None,
        user_features=None,
        num_threads=1,
        check_intersections=True,
    ):
        """Rank of every non-zero test interaction among all items.

        Returns a scipy CSR with the same sparsity as ``test_interactions``
        whose data holds 0-based ranks, excluding train positives -- the
        reference ``predict_rank`` (`lightfm/lightfm.py:884-989`) with its
        pessimistic ``>=`` ties (template:1318).  On a CUDA device the
        counting runs in the hand-written kernels of ``ops.rank_counts``.
        """
        self._check_initialized()

        if num_threads < 1:
            raise ValueError("Number of threads must be 1 or larger.")

        if check_intersections:
            self._check_test_train_intersections(test_interactions, train_interactions)

        n_users, n_items = test_interactions.shape

        (user_features, item_features) = self._construct_feature_matrices(
            n_users, n_items, user_features, item_features
        )

        if not item_features.shape[1] == self._table_shape("item")[0]:
            raise ValueError("Incorrect number of features in item_features")
        if not user_features.shape[1] == self._table_shape("user")[0]:
            raise ValueError("Incorrect number of features in user_features")

        # Identity-keyed memoization keeps the converted CSRs stable across
        # the per-epoch metric loop, so the tier prep hits its cache too.
        test_interactions = self._memo_by_identity(
            "test_csr",
            test_interactions,
            lambda m: m.tocsr().astype(CYTHON_DTYPE, copy=False),
        )
        if train_interactions is None:
            train_interactions = self._serving_cache.setdefault(
                ("empty_train", n_users, n_items),
                sp.csr_matrix((n_users, n_items), dtype=CYTHON_DTYPE),
            )
        else:
            train_interactions = self._memo_by_identity(
                "train_csr", train_interactions, lambda m: m.tocsr()
            )

        ranks_data = predict_ranks_padded(
            self._serving_state(),
            self._pad_features_cached(user_features),
            self._pad_features_cached(item_features),
            test_interactions,
            train_interactions,
            cache=self._serving_cache,
        )

        return sp.csr_matrix(
            (ranks_data, test_interactions.indices, test_interactions.indptr),
            shape=test_interactions.shape,
        )

    def recommend(
        self,
        user_ids,
        k=10,
        item_features=None,
        user_features=None,
        train_interactions=None,
        n_items=None,
        mode="auto",
        rerank_mult=4,
    ):
        """Top-k item recommendations for a batch of users.

        - ``"exact"``: IEEE fp32 catalog scoring + ``torch.topk``;
        - ``"approx"`` and ``"auto"`` (default): accepted for parity with
          the JAX package and served by the same exact top-k (PyTorch has
          no counterpart of the TPU's approximate top-k, so recall is 1.0);
        - ``"compressed"``: int8-quantized coarse scoring + exact fp32
          rerank of ``rerank_mult * k`` candidates.

        ``train_interactions`` (any scipy sparse) excludes known positives.
        Returns ``(scores [B, k], item_ids [B, k])`` numpy arrays.
        """
        self._check_initialized()
        from lightfm_tpu_torch import retrieval

        if self.mesh is not None:
            from lightfm_tpu_torch.parallel.mesh import check_mesh

            check_mesh(self.mesh)
        state = self._serving_state()
        user_ids = np.atleast_1d(np.asarray(user_ids, dtype=np.int32))
        if n_items is None:
            if item_features is not None:
                n_items = item_features.shape[0]
            elif train_interactions is not None:
                n_items = train_interactions.shape[1]
            elif getattr(self, "n_items_", None) is not None:
                n_items = self.n_items_
            else:
                n_items = state.item_table.shape[0]
        if item_features is None and getattr(self, "_item_features_used", False):
            raise ValueError(
                "This model was fitted with item_features; recommend() needs "
                "the same item_features to build catalog representations."
            )
        if user_features is None and getattr(self, "_user_features_used", False):
            raise ValueError(
                "This model was fitted with user_features; recommend() needs "
                "the same user_features to build user representations."
            )
        n_users = int(user_ids.max()) + 1 if len(user_ids) else 1

        (user_features, item_features) = self._construct_feature_matrices(
            n_users, n_items, user_features, item_features
        )
        user_feats = self._pad_features_cached(user_features)
        item_feats = self._pad_features_cached(item_features)

        exclude_idx = None
        if train_interactions is not None:
            tr = train_interactions.tocsr()
            sel_lengths = np.diff(tr.indptr)[user_ids]
            P = max(1, int(sel_lengths.max()) if len(sel_lengths) else 1)
            # Sentinel > any padded catalog width, so masking skips it.
            exclude = np.full((len(user_ids), P), np.iinfo(np.int32).max, np.int32)
            nnz_sel = int(sel_lengths.sum())
            if nnz_sel:
                row_of = np.repeat(np.arange(len(user_ids)), sel_lengths)
                pos = np.arange(nnz_sel) - np.repeat(
                    np.cumsum(sel_lengths) - sel_lengths, sel_lengths
                )
                flat = np.repeat(tr.indptr[user_ids], sel_lengths) + pos
                exclude[row_of, pos] = tr.indices[flat]
            exclude_idx = torch.from_numpy(exclude).to(self._device)

        uid = torch.from_numpy(user_ids).to(self._device)
        k = min(int(k), int(n_items))  # never return catalog padding
        # Catalog structures are cached for the identity-features case
        # (invalidated whenever model state changes).
        cacheable = item_features is None or self._is_identity(item_features)
        if mode == "compressed":
            index = self._serving_cache.get(("index", n_items)) if cacheable else None
            if index is None:
                index = retrieval.build_compressed_index(state, item_feats, n_items)
                if cacheable:
                    self._serving_cache[("index", n_items)] = index
            scores, ids = retrieval.top_k_compressed(
                state, user_feats, index, uid, k,
                exclude_idx=exclude_idx, rerank_mult=rerank_mult,
            )
        elif mode in ("auto", "exact", "approx") and self.mesh is not None:
            scores, ids = retrieval.top_k_sharded(
                state, user_feats, item_feats, uid, k, n_items, self.mesh,
                exclude_idx=exclude_idx,
            )
        elif mode in ("auto", "exact", "approx"):
            catalog = self._serving_cache.get(("catalog", n_items)) if cacheable else None
            if catalog is None and cacheable:
                # Streaming-size catalogs are padded to the tile multiple.
                multiple = (
                    131_072 if n_items > retrieval.STREAMING_CATALOG_LIMIT else 128
                )
                catalog = retrieval.build_catalog(
                    state, item_feats, n_items, multiple=multiple
                )
                self._serving_cache[("catalog", n_items)] = catalog
            scores, ids = retrieval.top_k(
                state, user_feats, item_feats, uid, k, n_items,
                exclude_idx=exclude_idx, catalog=catalog,
            )
        else:
            raise ValueError(f"Unknown retrieval mode: {mode!r}")
        return scores.cpu().numpy(), ids.to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------------
    # Representations / params (lightfm.py:991-1107)
    # ------------------------------------------------------------------

    def get_item_representations(self, features=None):
        self._check_initialized()
        if features is None:
            return self.item_biases, self.item_embeddings
        features = sp.csr_matrix(features, dtype=CYTHON_DTYPE)
        return features * self.item_biases, features * self.item_embeddings

    def get_user_representations(self, features=None):
        self._check_initialized()
        if features is None:
            return self.user_biases, self.user_embeddings
        features = sp.csr_matrix(features, dtype=CYTHON_DTYPE)
        return features * self.user_biases, features * self.user_embeddings

    def get_params(self, deep=True):
        return {
            "loss": self.loss,
            "learning_schedule": self.learning_schedule,
            "no_components": self.no_components,
            "learning_rate": self.learning_rate,
            "k": self.k,
            "n": self.n,
            "rho": self.rho,
            "epsilon": self.epsilon,
            "max_sampled": self.max_sampled,
            "item_alpha": self.item_alpha,
            "user_alpha": self.user_alpha,
            "random_state": self.random_state,
            "batch_size": self.batch_size,
            "mesh": self.mesh,
            "table_partition": self.table_partition,
            "shard_examples": self.shard_examples,
            "example_shuffle": self.example_shuffle,
            "fast_path": self.fast_path,
            "pool_kernels": self.pool_kernels,
            "user_pallas": self.user_pallas,
            "fast_precision": self.fast_precision,
            "shuffle_mode": self.shuffle_mode,
            "device": self.device,
        }

    def __sklearn_tags__(self):
        # sklearn >= 1.6 estimator-tags protocol; enables clone()/CV search.
        from sklearn.base import BaseEstimator

        tags = BaseEstimator.__sklearn_tags__(self)
        tags.input_tags.sparse = True
        tags.requires_fit = True
        return tags

    def set_params(self, **params):
        valid_params = self.get_params()
        for key, value in params.items():
            if key not in valid_params:
                raise ValueError(
                    "Invalid parameter %s for estimator %s. "
                    "Check the list of available parameters "
                    "with `estimator.get_params().keys()`."
                    % (key, self.__class__.__name__)
                )
            setattr(self, key, value)
        return self

    # ------------------------------------------------------------------
    # Pickling: store numpy arrays, not device tensors.
    # ------------------------------------------------------------------

    def __getstate__(self):
        self._sync_mirrors()  # pickle what the user sees, edits included
        state = None if self._state is None else self._whole_state()  # every rank calls it
        d = dict(self.__dict__)
        d.pop("_host_mirrors", None)
        d.pop("_mirror_snaps", None)
        d.pop("mesh", None)  # device handles are not picklable
        for name in ("_placement", "_assembled", "_state"):  # the whole state goes below
            d.pop(name, None)
        d.pop("_serving_cache", None)  # rebuildable device buffers
        # The staged device-resident training set: rebuilt by every fit.
        for name in ("_staged_train_data", "_staged_hp", "_staged_batch_size", "_staged_fast"):
            d.pop(name, None)
        d["_device"] = str(self._device)
        d["_state_np"] = (
            None if state is None
            else {name: x.cpu().numpy() for name, x in zip(ModelState._fields, state)}
        )
        return d

    def __setstate__(self, d):
        state_np = d.pop("_state_np", None)
        self.__dict__.update(d)
        self.mesh = None
        self._placement = self._assembled = None
        self._device = resolve_device(d["_device"])
        self._serving_cache = {}
        self._drop_mirrors()
        self._state = None
        if state_np is not None:
            missing = [n for n in ModelState._fields if n not in state_np]
            if missing:
                raise ValueError(
                    f"Pickled model state is missing fields {missing}; it may "
                    "come from an incompatible version."
                )
            self._state = ModelState(
                **{k: torch.tensor(state_np[k], device=self._device) for k in ModelState._fields}
            )


def _make_state_property(name):
    def getter(self):
        return self._get_field(name)

    def setter(self, value):
        self._set_field(name, value)

    return property(getter, setter)


for _f in _FIELD_MAP:
    setattr(LightFM, _f, _make_state_property(_f))
