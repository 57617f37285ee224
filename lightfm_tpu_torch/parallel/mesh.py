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
  slice; ``retrieval.top_k_sharded`` splits the catalog over it, and the
  row and component partitions split the tables over it.

Tables are placed by :func:`shard_state` (the JAX package's
``_table_spec`` / ``shard_state``), recorded per side as a
:class:`TablePlacement`:

- ``"replicated"``: every rank holds the whole table;
- ``"rows"``: rank m of the model axis holds rows ``[m R/n, (m+1) R/n)``
  of the table, its ``acc`` and its ``mom``; a table whose row count
  does not divide by ``n`` warns and stays replicated;
- ``"components"``: rank m holds columns ``[m W/n, (m+1) W/n)`` of every
  table (``ValueError`` when ``W`` does not divide).

Where GSPMD inserts collectives in the JAX package, a step here runs one
rule for both sharded layouts: it reassembles the rows its lookups read
(:meth:`TablePlacement.rows`), computes as over replicated tables, and
applies only the touches this rank holds (:meth:`TablePlacement.own`);
the lazy-L2 statistics of the owned touches are summed over the model axis
in rank order (:func:`sum_over_model`).

No rank ever holds the whole of a split state on its card: a fresh state
is drawn table by table and cut at once (``state.init_state``'s ``part``),
a whole state is sent part by part (:func:`place_state`), and the whole
state is assembled part by part into memory the caller names
(:func:`assemble`): the host for checkpoints, pickles and the state
attributes, the card for the item table that ``predict_rank`` scores.
Serving reads the rows of the users it serves through
:meth:`TablePlacement.rows` and never assembles the user table;
``recommend`` scores each model rank's block of the catalog, under
``"rows"`` with identity item features the rows the rank holds.

A world of one rank needs no process group: :func:`make_mesh` then builds a
mesh of one rank whose collectives return their inputs.
"""

from __future__ import annotations

import datetime
import os
import time
import warnings
from typing import NamedTuple, Optional

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

    Under NCCL the rank is bound to its card before the group starts: the
    card of :func:`make_mesh` (``cuda:LOCAL_RANK``, else ``cuda:rank %
    device_count``) becomes the current device and the group's
    ``device_id``, so no rank opens a context, or NCCL's communicator, on
    another rank's card.  Under gloo nothing is bound.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if "nccl" in backend:
        rank = kwargs.get("rank", os.environ.get("RANK"))
        if rank is None and "LOCAL_RANK" not in os.environ:
            raise ValueError("an NCCL rank needs its card: pass rank= or set LOCAL_RANK or RANK")
        card = _rank_device(-1 if rank is None else int(rank), None)
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
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


def _check_nccl_card(rank: int, world: int, dev: torch.device) -> None:
    """Raise unless an NCCL rank's device is a card of its own: NCCL
    refuses two ranks on one device, and a rank whose tensors lie on a
    card other than its bound one would launch there from the wrong
    context."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    here = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if here > cards:
        raise RuntimeError(
            f"NCCL runs one rank a card: {here} ranks on this machine, which has {cards} "
            "CUDA device(s); use fewer ranks, or gloo"
        )
    bound = torch.cuda.current_device()
    if dev != torch.device("cuda", bound):
        raise RuntimeError(
            f"rank {rank}'s mesh device is {dev}, but its process is bound to cuda:{bound}: "
            "start the group with initialize_multihost, or call torch.cuda.set_device "
            "with the rank's card first"
        )


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """Create a ``(data, model)`` mesh over the ranks of the process group.

    Every rank must call it, in the same order as its other calls of
    ``make_mesh``: it creates one ``dist.new_group`` per axis line.  The
    rank's device is ``device`` when given, else ``cuda:LOCAL_RANK`` (or
    ``cuda:rank % device_count``); without CUDA, ``device="cpu"`` must be
    passed (``RuntimeError`` otherwise: no silent CPU run).

    Under NCCL, one rank a card: ``RuntimeError`` when this machine runs
    more ranks (``LOCAL_WORLD_SIZE``, which ``torchrun`` sets, else the
    world) than it has cards, and when the rank's device is not the card
    it is bound to (the current device, :func:`initialize_multihost`).
    Gloo ranks may share a card.
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
    if "nccl" in backend:
        _check_nccl_card(rank, world, dev)
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
    uint8 block (bool as one byte), so one collective carries them all
    (one tensor: a view of it, no copy)."""
    parts, specs = [], []
    for t in tensors:
        t = t.contiguous()
        parts.append(t.view(torch.uint8).reshape(rows, -1))
        specs.append((t.dtype, tuple(t.shape[1:]), parts[-1].shape[1]))
    return (parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)), specs


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
    mesh.stats["bytes"] += block.numel() * block.element_size()
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


def _data_group(mesh: Mesh):
    """The data axis' group, or None when it holds this rank alone (a
    collective over one rank is a copy)."""
    return mesh.data_group if mesh.shape[DATA_AXIS] > 1 else None


def _model_group(mesh: Mesh):
    """The model axis' group, or None when it holds this rank alone."""
    return mesh.model_group if mesh.shape[MODEL_AXIS] > 1 else None


def all_gather_rows(mesh: Mesh, *tensors: torch.Tensor) -> list:
    """Tiled all-gather along dim 0 over the data axis: rank d's rows land
    at block d, so slices cut in data-axis order come back in batch order."""
    return _gather(mesh, _data_group(mesh), tensors)


def all_gather_model(mesh: Mesh, *tensors: torch.Tensor) -> list:
    """Tiled all-gather along dim 0 over the model axis."""
    return _gather(mesh, _model_group(mesh), tensors)


def _sum_in_rank_order(mesh: Mesh, group, tensors) -> list:
    """Sum of each tensor over ``group``: an all-gather, then a sum in rank
    order (not ``all_reduce``), so the order of the sum is fixed and the
    same on every rank and backend."""
    if group is None:
        return list(tensors)
    flat = [t.reshape(1, -1) for t in tensors]
    block, specs = _as_bytes(flat, 1)
    parts = [_from_bytes(b, specs) for b in _gather_block(mesh, group, block)]
    out = []
    for i, t in enumerate(tensors):
        acc = parts[0][i]
        for p in parts[1:]:
            acc = acc + p[i]
        out.append(acc.reshape(t.shape))
    return out


def sum_over_data(mesh: Mesh, *tensors: torch.Tensor) -> list:
    """Sum of each tensor over the data axis, in rank order."""
    return _sum_in_rank_order(mesh, _data_group(mesh), tensors)


def sum_over_model(mesh: Mesh, *tensors: torch.Tensor) -> list:
    """Sum of each tensor over the model axis, in rank order."""
    return _sum_in_rank_order(mesh, _model_group(mesh), tensors)


def gather_columns(mesh: Mesh, *tensors: torch.Tensor) -> list:
    """Tiled all-gather along dim 1 over the model axis: each tensor's
    columns of every model rank, concatenated in rank order (tensors that
    share their leading length go as one block)."""
    group = _model_group(mesh)
    if group is None:
        return list(tensors)
    block, specs = _as_bytes(tensors, tensors[0].shape[0])
    parts = [_from_bytes(b, specs) for b in _gather_block(mesh, group, block)]
    return [torch.cat([p[i] for p in parts], dim=1) for i in range(len(tensors))]


def _by_distinct(ids: torch.Tensor, width: int, like: torch.Tensor, fetch) -> torch.Tensor:
    """``[*ids.shape, width]`` rows of ``fetch(distinct ids)``, one row per
    distinct id (every rank of the model axis passes the same ids, so the
    empty case is every rank's alike and sends nothing)."""
    flat = ids.reshape(-1)
    if flat.numel() == 0:
        return like.new_zeros((*ids.shape, width))
    uniq, inv = torch.unique(flat, return_inverse=True)
    return fetch(uniq)[inv].reshape(*ids.shape, width)


def gather_owned_rows(mesh: Mesh, table: torch.Tensor, ids: torch.Tensor, start: int,
                      stop: int) -> torch.Tensor:
    """Rows ``ids`` of a table split by rows over the model axis, of which
    this rank holds rows ``[start, stop)`` as ``table``: ``[*ids.shape, W]``.

    Each rank fills the distinct ids it owns; one all-gather brings every
    rank's fill, and each row is taken from its owner's copy (not summed
    with the others' zeros, which would turn a ``-0.0`` into ``+0.0``).
    The bytes sent are the distinct rows, however often the lookup repeats
    them.
    """
    group = _model_group(mesh)
    if group is None:
        return table[ids - start]
    n_local = stop - start

    def fetch(uniq):
        owner = uniq // n_local  # the model coordinate that holds each row
        owned = (uniq >= start) & (uniq < stop)
        mine = table[torch.where(owned, uniq - start, torch.zeros_like(uniq))]
        block, specs = _as_bytes([mine], mine.shape[0])
        fills = [_from_bytes(b, specs)[0] for b in _gather_block(mesh, group, block)]
        rows = fills[0]  # a fresh buffer: rank 0's fill, then each owner's rows
        for m in range(1, len(fills)):
            take = owner == m
            rows[take] = fills[m][take]
        return rows

    return _by_distinct(ids, table.shape[1], table, fetch)


def gather_row_columns(mesh: Mesh, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of a table split by columns over the model axis
    (``table`` holds this rank's columns): the local columns of the
    distinct rows, all-gathered along dim 1."""
    if _model_group(mesh) is None:
        return table[ids]
    width = table.shape[1] * mesh.shape[MODEL_AXIS]
    return _by_distinct(ids, width, table, lambda uniq: gather_columns(mesh, table[uniq])[0])


def broadcast_from_rank0(mesh: Mesh, *tensors: torch.Tensor) -> list:
    """Rank 0's values of ``tensors`` on every rank of the world (each
    rank's own tensors give the shapes and dtypes)."""
    if not mesh.distributed:
        return list(tensors)
    flat = [t.reshape(1, -1) for t in tensors]
    block, specs = _as_bytes(flat, 1)
    block = _collective(mesh, block.clone(), lambda buf: _broadcast(buf, 0))
    return [x.reshape(t.shape) for x, t in zip(_from_bytes(block, specs), tensors)]


def _broadcast(buf: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``dist.broadcast`` in place from global rank ``src``; ``buf``."""
    dist.broadcast(buf.reshape(-1), src=src, group=group)
    return buf


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the world: a one-byte broadcast on the
    mesh's device, which every backend takes, read back on the host (NCCL
    only enqueues a collective, so the host waits for its result)."""
    broadcast_from_rank0(mesh, torch.zeros(1, dtype=torch.uint8, device=mesh.device))[0].cpu()


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


class TablePlacement(NamedTuple):
    """Where one side's table, with its ``acc`` and ``mom``, lives on this
    rank: ``layout`` ``"replicated"`` (the whole table), ``"rows"`` (rows
    ``[start, stop)``) or ``"components"`` (columns ``[start, stop)``);
    ``shape`` is the whole table's ``(rows, width)``."""

    mesh: Mesh
    layout: str
    start: int
    stop: int
    shape: tuple

    @property
    def sharded(self) -> bool:
        return self.layout != "replicated"

    @property
    def dim(self) -> int:
        """The dimension the table is split along."""
        return 0 if self.layout == "rows" else 1

    def rows(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Whole rows ``ids`` of the table whose part here is ``table``
        (a collective when the table is split: every rank of the model axis
        passes the same ids)."""
        if not self.sharded:
            return table[ids]
        if self.layout == "rows":
            return gather_owned_rows(self.mesh, table, ids, self.start, self.stop)
        return gather_row_columns(self.mesh, table, ids)

    def own(self, idx: torch.Tensor, mask: torch.Tensor, g: torch.Tensor):
        """The share of a batch's touches (global row ids ``idx``, gradients
        ``g`` of the whole width) that applies to the part held here, as
        ``(idx, mask, g, kw)`` for ``ops/updates.sparse_update(..., **kw)``.

        ``"rows"``: the ids become local; a touch of a row held elsewhere
        points at a local row (its id modulo the local row count, so no
        one row collects them all) and is masked, an exact no-op.
        ``"components"``: the gradient's columns held here, counted by
        their global index in the lazy-L2 statistics."""
        if self.layout == "rows":
            idx = idx.long()
            mine = (idx >= self.start) & (idx < self.stop)
            local = torch.where(mine, idx - self.start, idx % (self.stop - self.start))
            return local, mask & mine, g, {}
        if self.layout == "components":
            return idx, mask, g[:, self.start:self.stop], dict(col_offset=self.start,
                                                               full_width=self.shape[1])
        return idx, mask, g, {}


class Placement(NamedTuple):
    """A state's placement on a mesh: where each side's table went (under
    ``"rows"`` a table may fall back to replication)."""

    item: TablePlacement
    user: TablePlacement

    @property
    def mesh(self) -> Mesh:
        return self.item.mesh

    @property
    def sharded(self) -> bool:
        return self.item.sharded or self.user.sharded

    def side(self, field: str) -> Optional[TablePlacement]:
        """The placement of a ``ModelState`` field (None for the scales)."""
        if field.endswith("_log_scale"):
            return None
        return self.item if field.startswith("item_") else self.user

    def part(self, field: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``x`` of ``field``."""
        return local_part(x, self.side(field))


PARTITIONS = ("replicated", "rows", "components")


def plan_placement(mesh: Mesh, table_partition: str, item_shape, user_shape) -> Placement:
    """Where ``shard_state`` puts each table (``lightfm_tpu/parallel/mesh.py:
    68-127``): ``"rows"`` splits the row space over the model axis and
    replicates, with a warning, a table whose row count does not divide;
    ``"components"`` splits the columns and raises ``ValueError`` when the
    fused width does not divide; ``"replicated"`` copies every table."""
    if table_partition not in PARTITIONS:
        raise ValueError(f"table_partition must be one of {PARTITIONS}, got {table_partition!r}")
    n, m = mesh.shape[MODEL_AXIS], mesh.coords[MODEL_AXIS]
    if table_partition == "components" and item_shape[1] % n:
        raise ValueError(
            "'components' table partitioning requires the fused table "
            f"width (= {item_shape[1]}: embedding columns + zero pad + bias "
            f"column; see lightfm_tpu_torch.state.table_width) to be divisible "
            f"by the model-axis size {n}; pick a compatible "
            "no_components or use 'rows'."
        )
    warned: set = set()

    def side(shape) -> TablePlacement:
        shape = tuple(int(x) for x in shape)
        rows, width = shape
        if table_partition == "components":
            return TablePlacement(mesh, "components", m * width // n, (m + 1) * width // n, shape)
        if table_partition == "rows" and rows % n == 0:
            return TablePlacement(mesh, "rows", m * rows // n, (m + 1) * rows // n, shape)
        if table_partition == "rows" and rows not in warned:
            warned.add(rows)
            warnings.warn(
                f"table with {rows} rows is not divisible by the "
                f"model axis ({n}); replicating it instead "
                "of row-sharding",
                stacklevel=3,
            )
        return TablePlacement(mesh, "replicated", 0, rows, shape)

    return Placement(side(item_shape), side(user_shape))


def local_part(x: torch.Tensor, side: Optional[TablePlacement]) -> torch.Tensor:
    """This rank's part of a whole table tensor placed as ``side``, on
    ``x``'s device: a copy, so the whole tensor can go (the tensor itself
    when it is all of it)."""
    if side is None or not side.sharded or side.stop - side.start == x.shape[side.dim]:
        return x
    return x.narrow(side.dim, side.start, side.stop - side.start).clone(
        memory_format=torch.contiguous_format)


def _rank0_part(mesh: Mesh, x: torch.Tensor, side: Optional[TablePlacement]) -> torch.Tensor:
    """This rank's part of rank 0's whole tensor ``x``, on the mesh's
    device: rank 0 broadcasts the parts one after another, and each rank
    keeps its own, so a card holds one part beside the rank's."""
    if not mesh.distributed:
        return local_part(x, side).to(mesh.device)
    n = mesh.shape[MODEL_AXIS] if side is not None and side.sharded else 1
    size = x.shape[side.dim] // n if n > 1 else 0
    kept = None
    for m in range(n):
        piece = x if n == 1 else x.narrow(side.dim, m * size, size)
        buf = torch.empty(piece.shape, dtype=x.dtype, device=mesh.device)
        if mesh.rank == 0:
            buf.copy_(piece)
        buf = _collective(mesh, buf, lambda b: _broadcast(b, 0))
        if m == (mesh.coords[MODEL_AXIS] if n > 1 else 0):
            kept = buf
    return kept


def place_state(state, placement: Placement, current: Optional[Placement] = None):
    """``state`` placed as ``placement``.  ``current`` is the placement the
    state has (None: whole tensors on any device, which take rank 0's
    values, so every replica starts from rank 0's tables whatever each
    rank's ``random_state`` drew).  A state already placed as asked is
    returned as it is; a split one placed otherwise is assembled on the
    host first.  The card never holds a whole split table: each rank
    receives its part alone."""
    if current is not None and current == placement:
        return state
    mesh, names = placement.mesh, type(state)._fields
    if current is None:
        return type(state)(*(_rank0_part(mesh, x, placement.side(name))
                             for name, x in zip(names, state)))
    if current.sharded:  # equal on every rank once assembled
        state = assemble_state(state, current, device="cpu")
    return type(state)(*(placement.part(name, x).to(mesh.device)
                         for name, x in zip(names, state)))


def shard_state(state, mesh: Mesh, table_partition: str = "rows"):
    """Place a whole model state on the mesh (``lightfm_tpu/parallel/mesh.py:
    68-127``).

    ``"replicated"``: every tensor moves to the rank's device.
    ``"rows"``: each table's row space is split over the model axis (a
    table whose row count does not divide is replicated, with a warning).
    ``"components"``: the columns of every table are split over it.
    The tensors take rank 0's values.  To place a state again, which
    ``fit_partial`` does, :func:`place_state` takes the placement it has.
    """
    return place_state(state, plan_placement(mesh, table_partition, state.item_table.shape,
                                             state.user_table.shape))


def whole_shape(field: str, x: torch.Tensor, placement: Optional[Placement]) -> tuple:
    """The whole shape of a state field whose tensor here is ``x``."""
    side = None if placement is None else placement.side(field)
    return side.shape if side is not None and side.sharded else tuple(x.shape)


def assemble(state, placement: Placement, fields, device=None) -> dict:
    """The whole tensors of ``fields`` of a placed state on ``device`` (the
    mesh's by default), a collective that every rank of the model axis
    calls.  Each split tensor is preallocated whole on ``device``, and its
    parts are broadcast by their owners one after another over the model
    axis, so the card holds one part beside the rank's own (and nothing
    whole when ``device`` is the host)."""
    mesh = placement.mesh
    device = mesh.device if device is None else torch.device(device)
    group = _model_group(mesh)
    first = mesh.coords[DATA_AXIS] * mesh.shape[MODEL_AXIS]  # global rank of model rank 0
    out = {}
    for name in fields:
        x, side = getattr(state, name), placement.side(name)
        if side is None or not side.sharded:
            out[name] = x.to(device)
            continue
        whole = torch.empty(side.shape, dtype=x.dtype, device=device)
        if group is None:
            whole.copy_(x)
        else:
            size = x.shape[side.dim]
            for m in range(mesh.shape[MODEL_AXIS]):
                mine = m == mesh.coords[MODEL_AXIS]
                buf = (x.contiguous() if mine
                       else torch.empty_like(x, memory_format=torch.contiguous_format))
                buf = _collective(mesh, buf, lambda b: _broadcast(b, first + m, group))
                whole.narrow(side.dim, m * size, size).copy_(buf)
        out[name] = whole
    return out


def assemble_state(state, placement: Optional[Placement], device=None):
    """The whole state on ``device`` (the mesh's by default) on every rank
    of the model axis (a collective that every rank calls,
    :func:`assemble`).  A state with no split side is returned as it is."""
    if placement is None or not placement.sharded:
        return state
    return type(state)(**assemble(state, placement, type(state)._fields, device))


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
