"""Process mesh, table placement and collectives for multi-device training.

Counterpart of ``lightfm_tpu/parallel/mesh.py``.  The JAX package runs one
controller over every device and lets GSPMD and ``shard_map`` insert the
collectives; the port runs one process per rank with ``torch.distributed``
and calls its collectives by hand.  Every rank calls
``LightFM(mesh=mesh).fit(...)`` with the same arguments, and one rule keeps
the replicas exactly equal: every rank draws the same epoch, computes the
forward pass and gradients of its own contiguous slice of each batch,
all-gathers the per-example streams over the data axis in rank order, and
applies the same full-batch update.

- **data axis**: the batch is split over it; :func:`all_gather_rows` and
  :func:`sum_over_data` restore the full batch's update streams.
- **model axis**: ranks that share a data coordinate compute the same
  slice; ``retrieval.top_k_sharded`` splits the catalog over it.

Only replicated tables are ported.  Row and component partitions
(``table_partition="rows"`` / ``"components"``) raise
``NotImplementedError``: they are ROADMAP.md item 7b.

A world of one rank needs no process group: :func:`make_mesh` then builds a
mesh of one rank whose collectives return their inputs.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_multihost(backend: Optional[str] = None, timeout_s: float = 300.0,
                         **kwargs) -> None:
    """Start this rank's process group (``torch.distributed.init_process_group``).

    ``backend`` defaults to NCCL where CUDA exists and to gloo on the CPU
    (pass ``"gloo"`` for CPU ranks on a CUDA machine).  The other arguments
    pass through: ``init_method`` (for example ``"tcp://localhost:29500"``),
    ``world_size``, ``rank``; without them the ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` environment variables that
    ``torchrun`` sets are read.  ``timeout_s`` bounds every collective, the
    rendezvous included.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)


class Mesh:
    """A ``(data, model)`` grid of ranks, row-major: rank = d * n_model + m.

    ``data_group`` holds the ranks of this rank's model coordinate (its
    data axis), ``model_group`` those of its data coordinate; both are
    None in a world of one rank without a process group.  ``stats``
    counts this rank's collectives: calls, host-clock seconds spent in
    them and bytes sent.  gloo returns when a collective is done, so its
    seconds are the collectives' time; NCCL only enqueues them on the
    card's stream, so under NCCL the seconds are host enqueue time.
    """

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, n_data: int, n_model: int, rank: int, device: torch.device,
                 data_group=None, model_group=None, backend: Optional[str] = None):
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self.rank = rank
        self.coords = {DATA_AXIS: rank // n_model, MODEL_AXIS: rank % n_model}
        self.device = device
        self.data_group = data_group
        self.model_group = model_group
        self.backend = backend
        self.stats = {"calls": 0, "seconds": 0.0, "bytes": 0}

    @property
    def distributed(self) -> bool:
        return self.data_group is not None

    def reset_stats(self) -> None:
        self.stats = {"calls": 0, "seconds": 0.0, "bytes": 0}

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself, or ``TypeError`` for anything that is not a :class:`Mesh`."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a lightfm_tpu_torch.parallel.Mesh (make_mesh), got {type(mesh).__name__}"
        )
    return mesh


def check_partition(table_partition: str) -> None:
    """Raise for the table partitions that are not ported (ROADMAP.md item 7b)."""
    if table_partition != "replicated":
        raise NotImplementedError(
            f"table_partition={table_partition!r} is not ported yet: row and component "
            "partitions are ROADMAP.md item 7b; use table_partition='replicated'"
        )


def _rank_device(rank: int, device) -> torch.device:
    """``device`` when given, else this rank's card: ``cuda:LOCAL_RANK``,
    or ``cuda:rank % device_count``.  Without CUDA only ``device="cpu"``
    runs on the CPU, as for ``LightFM(device=...)``."""
    from lightfm_tpu_torch.model import resolve_device

    if device is not None or not torch.cuda.is_available():
        return resolve_device(device)
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else rank % torch.cuda.device_count())


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """Create a ``(data, model)`` mesh over the ranks of the process group.

    Every rank must call it, in the same order as its other calls of
    ``make_mesh``: it creates one ``dist.new_group`` per axis line.  The
    rank's device is ``device`` when given, else ``cuda:LOCAL_RANK`` (or
    ``cuda:rank % device_count``); without CUDA, ``device="cpu"`` must be
    passed (``RuntimeError`` otherwise: no silent CPU run).
    """
    if dist.is_initialized():
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(
            f"Mesh shape ({n_data}, {n_model}) does not match {world} devices"
        )
    dev = _rank_device(rank, device)
    if backend is None:
        return Mesh(n_data, n_model, rank, dev)
    data_group = model_group = None
    # Every rank creates every group, in the same order.
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = g
    return Mesh(n_data, n_model, rank, dev, data_group, model_group, backend)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _as_bytes(tensors, rows: int) -> tuple[torch.Tensor, list]:
    """Pack tensors with ``rows`` leading rows into one ``[rows, bytes]``
    uint8 block (bool as one byte), so one collective carries them all."""
    parts, specs = [], []
    for t in tensors:
        t = t.contiguous()
        parts.append(t.view(torch.uint8).reshape(rows, -1))
        specs.append((t.dtype, tuple(t.shape[1:]), parts[-1].shape[1]))
    return torch.cat(parts, dim=1), specs


def _from_bytes(block: torch.Tensor, specs) -> list:
    out, at = [], 0
    for dtype, rest, width in specs:
        piece = block[:, at:at + width].contiguous()
        out.append(piece.view(dtype).reshape(block.shape[0], *rest))
        at += width
    return out


def _collective(mesh: Mesh, block: torch.Tensor, op):
    """``op(block)``, a collective that returns a tensor or a list of them,
    counted in ``mesh.stats``.  The block stays on its device: NCCL and
    gloo both take CUDA tensors."""
    t0 = time.perf_counter()
    out = op(block)
    mesh.stats["calls"] += 1
    mesh.stats["seconds"] += time.perf_counter() - t0
    mesh.stats["bytes"] += block.numel()
    return out


def _gather_block(mesh: Mesh, group, block: torch.Tensor) -> list:
    """``dist.all_gather`` of one uint8 block over ``group``, in rank order."""
    n = dist.get_world_size(group)

    def op(buf):
        out = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(out, buf, group=group)
        return out

    return _collective(mesh, block, op)


def _gather(mesh: Mesh, group, tensors) -> list:
    """All-gather tensors that share their leading length over ``group``,
    concatenated along dim 0 in the group's rank order."""
    if group is None:
        return list(tensors)
    block, specs = _as_bytes(tensors, tensors[0].shape[0])
    return _from_bytes(torch.cat(_gather_block(mesh, group, block)), specs)


def all_gather_rows(mesh: Mesh, *tensors: torch.Tensor) -> list:
    """Tiled all-gather along dim 0 over the data axis: rank d's rows land
    at block d, so slices cut in data-axis order come back in batch order."""
    return _gather(mesh, mesh.data_group, tensors)


def all_gather_model(mesh: Mesh, *tensors: torch.Tensor) -> list:
    """Tiled all-gather along dim 0 over the model axis."""
    return _gather(mesh, mesh.model_group, tensors)


def sum_over_data(mesh: Mesh, *tensors: torch.Tensor) -> list:
    """Sum of each tensor over the data axis.  An all-gather, then a sum in
    rank order (not ``all_reduce``), so the order of the sum is fixed and
    the same on every rank and backend."""
    if mesh.data_group is None:
        return list(tensors)
    flat = [t.reshape(1, -1) for t in tensors]
    block, specs = _as_bytes(flat, 1)
    parts = [_from_bytes(b, specs) for b in _gather_block(mesh, mesh.data_group, block)]
    out = []
    for i, t in enumerate(tensors):
        acc = parts[0][i]
        for p in parts[1:]:
            acc = acc + p[i]
        out.append(acc.reshape(t.shape))
    return out


def broadcast_from_rank0(mesh: Mesh, *tensors: torch.Tensor) -> list:
    """Rank 0's values of ``tensors`` on every rank of the world (each
    rank's own tensors give the shapes and dtypes)."""
    if not mesh.distributed:
        return list(tensors)
    flat = [t.reshape(1, -1) for t in tensors]
    block, specs = _as_bytes(flat, 1)

    def op(buf):
        dist.broadcast(buf, src=0)
        return buf

    block = _collective(mesh, block, op)
    return [x.reshape(t.shape) for x, t in zip(_from_bytes(block, specs), tensors)]


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the world (a one-byte broadcast on the
    mesh's device, which every backend takes)."""
    broadcast_from_rank0(mesh, torch.zeros(1, dtype=torch.uint8, device=mesh.device))


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def shard_state(state, mesh: Mesh, table_partition: str = "rows"):
    """Place model state on the mesh.

    ``"replicated"``: every tensor moves to the rank's device and takes
    rank 0's values, so every replica starts from rank 0's tables whatever
    each rank's ``random_state`` drew.  ``"rows"`` and ``"components"``
    raise ``NotImplementedError`` (ROADMAP.md item 7b).
    """
    check_partition(table_partition)
    placed = [x.to(mesh.device) for x in state]
    return type(state)(*broadcast_from_rank0(mesh, *placed))


def shard_columns(packed: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's ``[8, n_pad / n_data]`` column slice of a packed block."""
    n_data = mesh.shape[DATA_AXIS]
    n_pad = packed.shape[1]
    if n_pad % n_data:
        raise ValueError(
            f"the padded example count ({n_pad}) must divide the data axis ({n_data})"
        )
    n_local = n_pad // n_data
    d = mesh.coords[DATA_AXIS]
    return packed[:, d * n_local:(d + 1) * n_local].contiguous()


def shard_train_data(data, mesh: Mesh, shard_examples: bool = False):
    """Place training data on the mesh.

    By default the example block stays whole on every rank: the epoch's
    global shuffle permutes the whole set and each rank takes its slice of
    every batch.  With ``shard_examples=True`` each rank keeps only its data
    coordinate's ``[8, n_pad / n_data]`` column slice; a global shuffle then
    all-gathers the block once an epoch (the exchange XLA inserts in the
    JAX package), and ``example_shuffle="local"`` needs no exchange.
    Feature structures and the positives stay whole on every rank.
    """
    if not shard_examples:
        return data
    return data._replace(packed=shard_columns(data.packed, mesh), examples_sharded=True)
