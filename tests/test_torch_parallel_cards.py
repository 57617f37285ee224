"""One NCCL rank a card: the port's card binding and its refusals, and
``chip_smoke.py``'s plan for its child ranks, on the CPU.

``torch.cuda`` is monkeypatched to report four cards, with a current
device that ``set_device`` moves; ``dist.init_process_group`` is recorded,
not run, and ``make_mesh`` reads a process group that ``dist``'s queries
describe.  No rank starts: the gloo ranks of ``test_torch_parallel*.py``
run the collectives themselves.
"""

import json
import os
import sys
import types

import pytest
import torch
import torch.distributed as dist

from lightfm_tpu_torch.parallel import initialize_multihost, make_mesh
from lightfm_tpu_torch.parallel import mesh as pmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

INIT = dict(init_method="tcp://localhost:29500", timeout_s=60.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cards(monkeypatch):
    """``torch.cuda`` with four cards; ``cards["set"]`` lists each
    ``set_device`` call's index, ``cards["current"]`` the current device."""
    state = {"current": 0, "set": []}

    def set_device(d):
        index = d if isinstance(d, int) else torch.device(d).index
        state["set"].append(index)
        state["current"] = index

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    return state


@pytest.fixture
def started(monkeypatch):
    """The keyword arguments of each ``dist.init_process_group`` call."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    return calls


def _group(monkeypatch, world: int, rank: int, backend: str):
    """What ``make_mesh`` reads of a process group of ``world`` ranks, seen
    from ``rank``; ``new_group`` returns the ranks it was given."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(dist, "new_group", lambda ranks, **kw: tuple(ranks))


# ---------------------------------------------------------------------------
# The port: initialize_multihost and make_mesh
# ---------------------------------------------------------------------------


def test_local_rank_binds_its_card_before_the_group_starts(monkeypatch, cards, started):
    monkeypatch.setenv("LOCAL_RANK", "2")
    initialize_multihost(backend="nccl", world_size=4, rank=2, **INIT)
    assert cards["set"] == [2]
    (kw,) = started
    assert kw["backend"] == "nccl" and kw["device_id"] == torch.device("cuda", 2)
    assert (kw["world_size"], kw["rank"]) == (4, 2) and kw["timeout"].total_seconds() == 60.0
    _group(monkeypatch, 4, 2, "nccl")
    mesh = make_mesh(n_data=2, n_model=2)
    assert mesh.device == torch.device("cuda", 2) and mesh.coords == {"data": 1, "model": 0}
    assert (mesh.data_group, mesh.model_group) == ((0, 2), (2, 3))


def test_without_local_rank_rank_5_binds_card_1(monkeypatch, cards, started):
    initialize_multihost(backend="nccl", world_size=8, rank=5, **INIT)
    assert cards["set"] == [1] and started[0]["device_id"] == torch.device("cuda", 1)
    # Two machines of four cards: torchrun's LOCAL_WORLD_SIZE counts this one's ranks.
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    _group(monkeypatch, 8, 5, "nccl")
    assert make_mesh(n_data=8).device == torch.device("cuda", 1)


def test_rank_comes_from_the_environment_or_the_rank_raises(monkeypatch, cards, started):
    with pytest.raises(ValueError, match="needs its card"):
        initialize_multihost(backend="nccl", **INIT)
    assert cards["set"] == [] and started == []
    monkeypatch.setenv("RANK", "3")
    initialize_multihost(backend="nccl", **INIT)
    assert cards["set"] == [3] and started[0]["device_id"] == torch.device("cuda", 3)


def test_default_backend_on_cuda_is_nccl_and_binds(cards, started):
    initialize_multihost(world_size=2, rank=1, **INIT)
    assert started[0]["backend"] == "nccl" and cards["set"] == [1]


@pytest.mark.parametrize("world, local_world", [(8, None), (5, None), (8, "8")])
def test_nccl_world_larger_than_the_card_count_raises(monkeypatch, cards, world, local_world):
    if local_world is not None:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    cards["current"] = 1
    _group(monkeypatch, world, 1, "nccl")
    with pytest.raises(RuntimeError, match=f"one rank a card: {world} ranks on this machine, "
                                           "which has 4"):
        make_mesh(n_data=world)


def test_nccl_mesh_off_its_bound_card_raises(monkeypatch, cards):
    _group(monkeypatch, 4, 1, "nccl")
    with pytest.raises(RuntimeError, match=r"cuda:1, but its process is bound to cuda:0"):
        make_mesh(n_data=4)  # the group started without binding the card
    cards["current"] = 1
    assert make_mesh(n_data=4).device == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match=r"cuda:3, but its process is bound to cuda:1"):
        make_mesh(n_data=4, device="cuda:3")
    with pytest.raises(RuntimeError, match=r"is cpu, but its process is bound to cuda:1"):
        make_mesh(n_data=4, device="cpu")


def test_gloo_is_unchanged(monkeypatch, cards, started):
    initialize_multihost(backend="gloo", world_size=8, rank=5, **INIT)
    assert cards["set"] == [] and "device_id" not in started[0]
    assert started[0]["backend"] == "gloo"
    # Eight gloo ranks on four cards share them, bound or not.
    _group(monkeypatch, 8, 5, "gloo")
    assert make_mesh(n_data=8).device == torch.device("cuda", 1)
    assert make_mesh(n_data=4, n_model=2, device="cpu").device == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert make_mesh(n_data=8).device == torch.device("cuda", 3)
    assert cards["set"] == []


def test_barrier_waits_on_the_host_for_its_broadcast(monkeypatch):
    """Under NCCL a broadcast returns once enqueued: ``barrier`` reads its
    result back, so the host waits until every rank has joined."""
    read = []

    class Result:
        def cpu(self):
            read.append(True)
            return self

    monkeypatch.setattr(pmesh, "broadcast_from_rank0", lambda mesh, *t: [Result()])
    pmesh.barrier(make_mesh(device="cpu"))
    assert read == [True]


# ---------------------------------------------------------------------------
# chip_smoke.py's pure helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_cards, world, want", [
    (1, 4, [0, 0, 0, 0]),
    (2, 4, [0, 1, 0, 1]),
    (4, 2, [0, 1]),
    (4, 4, [0, 1, 2, 3]),
    (8, 4, [0, 1, 2, 3]),
])
def test_the_card_each_rank_expects(n_cards, world, want):
    assert [chip_smoke.rank_card(r, n_cards) for r in range(world)] == want
    where = chip_smoke._where(world, n_cards)
    assert where == ("sharing cuda:0" if n_cards == 1
                     else "on " + ", ".join(f"cuda:{c}" for c in want))


@pytest.mark.parametrize("n_cards, ranks, parts", [
    (1, 0, ()),
    (2, 2, ("a", "b", "c")),
    (3, 2, ("a", "b", "c")),
    (4, 4, ("a", "b", "c", "d")),
    (8, 4, ("a", "b", "c", "d")),
])
def test_phase_12_plan(n_cards, ranks, parts):
    plan = chip_smoke.cards_plan(n_cards)
    assert plan == {"ranks": ranks, "parts": parts}
    if ranks:  # the row splits of both tables at synth-5m-warp-d64's sizes
        assert chip_smoke.TRAIN_ITEMS % ranks == 0 and chip_smoke.TRAIN_USERS % ranks == 0


class _Child:
    """A stand-in for a child rank: exits with ``rc`` at once (or never)."""

    def __init__(self, cmd, env, out_dir, rc):
        self.cmd, self.env, self.returncode, self.killed = cmd, env, None, False
        self._rc = rc
        rank = int(cmd[cmd.index("--rank") + 1])
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank}, f)

    def poll(self):
        if self.returncode is None and self._rc is not None:
            self.returncode = self._rc
        return self.returncode

    def kill(self):
        self.killed, self.returncode = True, -9

    def wait(self):
        return self.returncode


def _fake_popen(monkeypatch, tmp_path, rcs):
    children = []

    def popen(cmd, env, stdout, stderr, cwd):
        children.append(_Child(cmd, env, str(tmp_path), rcs[len(children)]))
        return children[-1]

    monkeypatch.setattr(chip_smoke, "subprocess",
                        types.SimpleNamespace(Popen=popen, STDOUT=None, run=None))
    return children


def test_run_ranks_gives_each_child_its_card(monkeypatch, tmp_path, cards):
    children = _fake_popen(monkeypatch, tmp_path, [0, 0, 0, 0])
    outs = chip_smoke.run_ranks(torch, "nccl", 4, 0, str(tmp_path), part="cards",
                                timeout_s=30, pg_timeout_s=20)
    assert outs == [{"rank": r} for r in range(4)]
    assert [c.env["LOCAL_RANK"] for c in children] == ["0", "1", "2", "3"]
    assert all(c.env["NCCL_DEBUG"] for c in children)
    cmd = children[0].cmd
    assert cmd[cmd.index("--pg-timeout") + 1] == "20" and cmd[cmd.index("--part") + 1] == "cards"


def test_run_ranks_kills_the_rest_once_a_rank_fails(monkeypatch, tmp_path, cards):
    """An NCCL rank may wait on a dead peer until its group's timeout: the
    others are killed ``RANK_GRACE_S`` after the first failure."""
    monkeypatch.setattr(chip_smoke, "RANK_GRACE_S", 0.2)
    children = _fake_popen(monkeypatch, tmp_path, [None, 1])
    with pytest.raises(AssertionError, match=r"exited 0 \(\[-9, 1\]; killed after a rank "
                                             r"failed: \[0\]\)"):
        chip_smoke.run_ranks(torch, "gloo", 2, 0, str(tmp_path), timeout_s=30)
    assert children[0].killed and not children[1].killed


def test_run_ranks_kills_ranks_past_the_deadline(monkeypatch, tmp_path, cards):
    children = _fake_popen(monkeypatch, tmp_path, [0, None])
    with pytest.raises(AssertionError, match=r"rank\(s\) \[1\] outlived 0.3 s"):
        chip_smoke.run_ranks(torch, "nccl", 2, 0, str(tmp_path), timeout_s=0.3)
    assert children[1].killed


def test_collective_clock_counts_bytes_and_bus_bytes(monkeypatch):
    """Device time from events around each collective; an all-gather of n
    blocks moves n - 1 blocks into the rank, a broadcast one."""
    class Event:  # every collective takes 2 ms
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 2.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(pmesh, "_collective", pmesh._collective)  # restored after the test
    clock = chip_smoke.CollectiveClock(torch)
    mesh = make_mesh(device="cpu")
    block = torch.zeros(1000, 250, dtype=torch.uint8)  # 0.25 MB
    pmesh._collective(mesh, block, lambda b: [b] * 4)
    pmesh._collective(mesh, block, lambda b: [b] * 4)
    pmesh._collective(mesh, block, lambda b: b)
    kinds = clock.take()
    assert kinds["all_gather"] == {"calls": 2, "block_mb": 0.5, "bus_mb": 1.5, "ms": 4.0,
                                   "median_ms": 2.0, "bus_gb_s": 0.375, "median_bus_gb_s": 0.375}
    assert kinds["broadcast"]["bus_mb"] == 0.25 and kinds["broadcast"]["calls"] == 1
    assert mesh.stats["calls"] == 3 and clock.take() == {}


def test_compute_apps_counts_processes_by_card(monkeypatch):
    out = {"--query-gpu=index,uuid": "0, GPU-a\n1, GPU-b\n2, GPU-c\n3, GPU-d\n",
           "--query-compute-apps=pid,gpu_uuid,used_memory":
               "10, GPU-a, 700 MiB\n11, GPU-a, 900 MiB\n12, GPU-b, 900 MiB\n13, GPU-d, 900 MiB\n"}

    def run(cmd, **kw):
        return types.SimpleNamespace(stdout=out[cmd[1]])

    monkeypatch.setattr(chip_smoke, "subprocess", types.SimpleNamespace(run=run))
    apps = chip_smoke.compute_apps(4)
    assert apps["per_card"] == [2, 1, 0, 1] and len(apps["lines"]) == 4
    out["--query-compute-apps=pid,gpu_uuid,used_memory"] = ""
    assert chip_smoke.compute_apps(4) == {"lines": [], "per_card": [0, 0, 0, 0]}
