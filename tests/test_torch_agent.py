"""The port's elastic agent and its checkpoint saver, on the CPU.

- the agent over ``python -c`` workers and an in-process master: exit
  0 is success; a failing worker is restarted with
  ``DLROVER_TPU_RESTART_COUNT`` 1 and a new rendezvous round; a spent
  restart budget fails the node with the worker's exit code, and the
  master hears of it; ``--nproc 2`` spawns two workers with their ranks;
- the worker's environment: the JAX agent's ``_worker_env`` keys and
  values for the same rendezvous outcome (less its XLA compile-cache
  variables), plus torch's ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR`` and ``MASTER_PORT``;
- the saver in agent mode: a step staged by an agent-mode engine and
  persisted by the agent's ``AsyncCheckpointSaver`` is byte for byte the
  pack the standalone engine commits, and the JAX package restores it;
  a memory save skips while the agent holds the lock, and a disk save
  waits for it and commits; a restore takes the agent's staged pack at
  the master's minimum step;
- a worker killed while it holds the agent's lock mid-stage: the
  broker releases the dead holder's lock at once (the JAX lock would
  wait out its 60 s timeout), and the persist finds the header
  incomplete and commits nothing newer.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time
import types
import uuid

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from dlrover_tpu.agent import agent as jagent  # noqa: E402
from dlrover_tpu.agent.rendezvous import (  # noqa: E402
    RendezvousOutcome as JOutcome,
)
from dlrover_tpu.checkpoint import core as jcore  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.parallel.mesh import single_device_mesh  # noqa: E402
from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu.train import train_step as jts  # noqa: E402
from dlrover_tpu_torch.agent import agent as tagent  # noqa: E402
from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa: E402
from dlrover_tpu_torch.agent.rendezvous import (  # noqa: E402
    RendezvousOutcome as TOutcome,
)
from dlrover_tpu_torch.checkpoint import core  # noqa: E402
from dlrover_tpu_torch.checkpoint.engine import (  # noqa: E402
    CheckpointEngine,
    shm_name,
)
from dlrover_tpu_torch.checkpoint.saver import (  # noqa: E402
    AsyncCheckpointSaver,
)
from dlrover_tpu_torch.checkpoint.storage import read_tracker  # noqa: E402
from dlrover_tpu_torch.master.master import LocalJobMaster  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CFG = dict(n_layer=2, d_model=64, n_head=2, n_kv_head=1, d_ff=128,
            vocab_size=256, max_seq=32, tie_embeddings=False,
            dtype="float32")
_OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=20,
            grad_clip=1.0)


@pytest.fixture(autouse=True)
def _run_id(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_RUN_ID", "agt" + uuid.uuid4().hex[:12])
    yield
    CheckpointEngine.unlink_segment()


# ---- the agent over python -c workers --------------------------------------


def _agent(entry, max_restarts=1, nproc=1):
    master = LocalJobMaster(port=0, num_workers=1)
    master.prepare()
    client = MasterClient(master.addr, node_id=0)
    client.register_node(local_chips=nproc)
    config = tagent.ElasticLaunchConfig(
        local_chips=nproc, max_restarts=max_restarts,
        monitor_interval_s=0.05, heartbeat_interval_s=3600,
        coordinator_port=0,
        entrypoint=[sys.executable, "-c", textwrap.dedent(entry)])
    return master, tagent.ElasticTrainingAgent(config, client)


def test_a_worker_that_exits_0_succeeds():
    master, agent = _agent("import sys; sys.exit(0)")
    try:
        assert agent.run() == 0
        assert master.job_manager.all_workers_succeeded()
    finally:
        master.stop()


def test_a_failed_worker_restarts_with_its_restart_count(tmp_path):
    log = tmp_path / "runs.txt"
    master, agent = _agent(f"""
        import os, sys
        with open({str(log)!r}, "a") as f:
            f.write(os.environ["DLROVER_TPU_RESTART_COUNT"] + " "
                    + os.environ["DLROVER_TPU_RDZV_ROUND"] + "\\n")
        sys.exit(0 if os.environ["DLROVER_TPU_RESTART_COUNT"] == "1" else 5)
    """)
    try:
        assert agent.run() == 0
    finally:
        master.stop()
    assert log.read_text().split("\n")[:2] == ["0 1", "1 2"]


def test_a_spent_budget_fails_the_node_with_the_exit_code():
    master, agent = _agent("import sys; sys.exit(7)", max_restarts=1)
    try:
        assert agent.run() == 7
        node = master.job_manager.get_node(0)
        assert (node.status, node.exit_reason) == ("failed", "fatal_error")
    finally:
        master.stop()


def test_two_workers_a_node_get_their_ranks(tmp_path):
    log = tmp_path / "ranks.txt"
    master, agent = _agent(f"""
        import os
        keys = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE")
        with open({str(log)!r}, "a") as f:
            f.write(" ".join(os.environ[k] for k in keys) + "\\n")
    """, nproc=2)
    try:
        assert agent.run() == 0
    finally:
        master.stop()
    assert sorted(log.read_text().split("\n")[:2]) == ["0 0 2 2", "1 1 2 2"]


# ---- the worker environment --------------------------------------------------


def _env_pair(world, node_rank, local_chips, local_rank=0):
    ranks = sorted(world)
    common = dict(round=3, group=0, world=world, coordinator="hostA:29400",
                  process_id=ranks.index(node_rank),
                  num_processes=len(ranks),
                  global_chips=sum(world.values()))
    client = types.SimpleNamespace(
        node_rank=node_rank, addr="m:1",
        _t=types.SimpleNamespace(addr="m:1"))
    jcfg = jagent.ElasticLaunchConfig(node_id=5, local_chips=local_chips,
                                      max_restarts=3)
    ja = jagent.ElasticTrainingAgent(jcfg, client)
    ja._remaining_restarts = 2
    tcfg = tagent.ElasticLaunchConfig(node_id=5, local_chips=local_chips,
                                      max_restarts=3)
    ta = tagent.ElasticTrainingAgent(tcfg, client)
    ta._remaining_restarts = 2
    offset = sum(world[r] for r in ranks if r < node_rank)
    theirs = ja._worker_env(JOutcome(**common))
    mine = ta._worker_env(TOutcome(rank_offset=offset, **common),
                          local_rank)
    return theirs, mine


TORCH_KEYS = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
              "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT")
XLA_KEYS = ("JAX_COMPILATION_CACHE_DIR",
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS")


@pytest.mark.parametrize("world,node_rank,local_rank", [
    ({0: 1}, 0, 0), ({0: 4, 1: 4, 3: 4}, 3, 2), ({2: 8, 7: 8}, 2, 5)])
def test_the_worker_env_is_the_jax_agents_plus_torchs(world, node_rank,
                                                      local_rank):
    theirs, mine = _env_pair(world, node_rank, world[node_rank], local_rank)
    assert {k: v for k, v in mine.items() if k not in TORCH_KEYS} == \
        {k: v for k, v in theirs.items() if k not in XLA_KEYS}
    ranks = sorted(world)
    offset = sum(world[r] for r in ranks if r < node_rank)
    assert {k: mine[k] for k in TORCH_KEYS} == {
        "RANK": str(offset + local_rank), "LOCAL_RANK": str(local_rank),
        "WORLD_SIZE": str(sum(world.values())),
        "LOCAL_WORLD_SIZE": str(world[node_rank]),
        "GROUP_RANK": str(ranks.index(node_rank)),
        "MASTER_ADDR": "hostA", "MASTER_PORT": "29400"}


# ---- the saver in agent mode -------------------------------------------------


def _state(seed=3):
    cfg = get_config("tiny", **_CFG)
    ttx = topt.make_optimizer(**_OPT)
    state = tts.init_train_state(1, cfg, ttx, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in state["params"].parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    state["step"] = 3
    return cfg, ttx, state


def _pack_bytes(ckpt_dir, step):
    with open(os.path.join(ckpt_dir, f"step_{step}", "host_0.pack"),
              "rb") as f:
        return f.read()


def test_the_agents_persist_is_the_standalone_pack_and_jax_restores_it(
        tmp_path, monkeypatch):
    cfg, ttx, state = _state()
    d = str(tmp_path / "ckpt")
    saver = AsyncCheckpointSaver(local_world_size=1)
    try:
        eng = CheckpointEngine(d)
        assert eng.use_agent
        assert eng.save_to_storage(3, convert.train_state_leaves(
            state, cfg, ttx))
        assert eng.wait_for_persist(30)
        by_agent = _pack_bytes(d, 3)
        assert [t["by"] for t in saver.timings] == ["queue"]
        # an emergency persist of the same step writes nothing again
        assert not saver.save_shm_to_storage()
    finally:
        saver.close(unlink=True)
    assert not os.path.exists(f"/dev/shm/{shm_name(0)}")
    os.remove(os.path.join(d, "step_3", "host_0.pack"))
    monkeypatch.setenv("DLROVER_TPU_RUN_ID", "agt" + uuid.uuid4().hex[:12])
    eng = CheckpointEngine(d)
    assert not eng.use_agent
    eng.save_to_storage(3, convert.train_state_leaves(state, cfg, ttx))
    eng.wait_for_persist(30)
    eng.close()
    assert _pack_bytes(d, 3) == by_agent
    # the JAX package restores the agent's pack
    jcfg = jget("tiny", **_CFG)
    st = jts.init_train_state(jax.random.key(0), jcfg, single_device_mesh(),
                              jopt.make_optimizer(**_OPT))
    idx = jcore.PackIndex()
    idx.add_pack(memoryview(bytearray(by_agent)))
    template = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            st)
    restored = jcore.restore_tree(template, idx)
    idx.close()
    want = convert.train_state_arrays(state, cfg, ttx)
    for path, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      want[jcore._path_str(path)])


class _MinStep:
    """A master client stub: the cluster's minimum staged step."""

    def __init__(self, step):
        self.step, self.reported = step, []

    def report_ckpt_step(self, step, rank=None):
        self.reported.append((step, rank))

    def get_min_ckpt_step(self):
        return self.step


def test_agent_mode_skips_while_the_agent_reads_and_restores_the_min_step(
        tmp_path):
    cfg, ttx, state = _state()
    d = str(tmp_path / "ckpt")
    saver = AsyncCheckpointSaver(local_world_size=1)
    try:
        client = _MinStep(3)
        eng = CheckpointEngine(d, master_client=client)
        leaves = convert.train_state_leaves(state, cfg, ttx)
        assert eng.save_to_memory(3, leaves)
        assert client.reported == [(3, 0)]
        saver.shm_locks[0].acquire(owner="saver")
        assert not eng.save_to_memory(4, leaves)  # the agent is reading
        saver.shm_locks[0].release(owner="saver")
        eng.close()
        fresh = convert.train_state_leaves(_state(seed=9)[2], cfg, ttx)
        new = CheckpointEngine(d, master_client=client)
        assert new.load(fresh) == 3 and new.timings[-1]["tier"] == "memory"
        client.step = 2  # another rank staged only step 2: not this tier
        other = CheckpointEngine(d, master_client=client)
        assert other.load(fresh) is None
        other.close()
        new.close()
    finally:
        saver.close(unlink=True)


def test_agent_mode_disk_save_waits_for_the_persist_in_flight(
        tmp_path, monkeypatch):
    """A disk save while the agent persists waits for it, and commits
    (the JAX engine drops it); a wait that runs out saves nothing."""
    import threading

    from dlrover_tpu_torch.checkpoint import engine

    cfg, ttx, state = _state()
    d = str(tmp_path / "ckpt")
    saver = AsyncCheckpointSaver(local_world_size=1)
    try:
        eng = CheckpointEngine(d)
        leaves = convert.train_state_leaves(state, cfg, ttx)
        saver.shm_locks[0].acquire(owner="saver")
        monkeypatch.setattr(engine, "PERSIST_WAIT_S", 0.2)
        assert not eng.save_to_storage(4, leaves)
        assert eng.timings[-1] == {"kind": "skipped", "step": 4}
        monkeypatch.setattr(engine, "PERSIST_WAIT_S", 30.0)
        threading.Timer(
            0.5, saver.shm_locks[0].release, kwargs={"owner": "saver"}
        ).start()
        assert eng.save_to_storage(5, leaves)
        assert eng.timings[-1]["wait_s"] >= 0.4
        assert eng.wait_for_persist(30)
        assert read_tracker(d, saver.storage) == 5
        eng.close()
    finally:
        saver.close(unlink=True)


_HOLDER = """
import sys, time, torch
sys.path.insert(0, {root!r})
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine, shm_name
from dlrover_tpu_torch.checkpoint import core
from dlrover_tpu_torch.common.multi_process import (
    SharedLockClient, attach_shared_memory)
leaf = core.Leaf("w", "float32", [4], [core.Shard([[0, 4]], torch.ones(4))])
eng = CheckpointEngine({d!r})
assert eng.use_agent and eng.save_to_memory(2, [leaf])
eng.close()
# a stage of step 4 starts: the lock taken, the header length zeroed
assert SharedLockClient("ckpt_0").acquire(blocking=False)
shm = attach_shared_memory(shm_name(0))
shm.buf[:core.HEADER_LEN_BYTES] = bytes(core.HEADER_LEN_BYTES)
print("holding", flush=True)
time.sleep(600)
"""


def test_a_worker_killed_holding_the_lock_leaves_no_torn_commit(tmp_path):
    d = str(tmp_path / "ckpt")
    saver = AsyncCheckpointSaver(local_world_size=1)
    proc = subprocess.Popen(
        [sys.executable, "-c", _HOLDER.format(root=ROOT, d=d)],
        stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "holding"
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
        t0 = time.monotonic()
        assert not saver.save_shm_to_storage()
        assert time.monotonic() - t0 < 5.0  # not the JAX lock's 60 s
        assert saver.shm_locks[0].dead_holders == [f"pid-{proc.pid}"]
        assert [t["kind"] for t in saver.timings] == ["torn"]
        assert read_tracker(d, saver.storage) is None
        assert not os.path.exists(os.path.join(d, "step_2"))
    finally:
        if proc.poll() is None:
            proc.kill()
        saver.close(unlink=True)


def test_the_agents_lock_loses_no_update_under_contention():
    """More threads than cores take the broker's lock through its socket
    and do a read-modify-write under it: no update is lost."""
    import threading

    from dlrover_tpu_torch.common.multi_process import (
        SharedLock,
        SharedLockClient,
    )

    lock = SharedLock("stress")
    box = {"n": 0}
    per, threads = 25, os.cpu_count() * 2

    def work(i):
        client = SharedLockClient("stress", owner=f"thread-{i}")
        for _ in range(per):
            assert client.acquire(timeout=30)
            n = box["n"]
            time.sleep(0)
            box["n"] = n + 1
            assert client.release()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,), daemon=True)
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
        lock.close()
    assert box["n"] == per * threads
