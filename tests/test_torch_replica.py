"""The port's replica ring (``checkpoint/replica.py``) and the engine's
replica tier against the JAX package's, on the CPU. Every comparison is
exact.

- The two rings talk to each other both ways: a port manager backs a
  staged pack up into a JAX manager's store and fetches it back, and
  the reverse (the frames and the auth preamble byte for byte).
- Backup targets and the holders a fetch asks, in order, equal JAX's
  for n = 2..5 and ``num_replicas`` = 0..3.
- The store (stale resend, byte budget), a wrong token, and ``fetch``
  with ``exclude``/``with_holder`` behave as JAX's on the same calls.
- The engine restores memory, then replica, then storage; a corrupt
  holder makes it try the next; the master's minimum staged step pins
  the step; a tree mismatch in the tier re-raises; a pack restored
  through the replica tier equals, bit for bit, the same pack restored
  by the JAX engine through its own replica tier.
- The reference finding (ROADMAP C): a JAX store lives in the worker
  that built the ``Checkpointer``, so a worker restart takes the peers'
  packs with it; the port's agent-held store keeps them.

Every store binds 127.0.0.1 and advertises it (``DLROVER_TPU_REPLICA_HOST``
is set, so nothing probes for a route). Each test stages under a run id
of its own and removes its segments.
"""

import os
import threading
import uuid

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.checkpoint import engine as jengine  # noqa: E402
from dlrover_tpu.checkpoint import replica as jrep  # noqa: E402
from dlrover_tpu_torch.checkpoint import core, replica  # noqa: E402
from dlrover_tpu_torch.checkpoint.engine import (  # noqa: E402
    CheckpointEngine,
    shm_name,
)
from dlrover_tpu_torch.common.multi_process import (  # noqa: E402
    attach_shared_memory,
    create_shared_memory,
    unlink_shared_memory,
)

TOKEN = "replica-test-token"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    run = "rep" + uuid.uuid4().hex[:12]
    monkeypatch.setenv("DLROVER_TPU_RUN_ID", run)
    monkeypatch.setenv("DLROVER_TPU_REPLICA_HOST", "127.0.0.1")
    monkeypatch.setenv("DLROVER_TPU_WIRE_TOKEN", TOKEN)
    yield run
    for f in os.listdir("/dev/shm"):
        if run in f:
            unlink_shared_memory(attach_shared_memory(f))


def _cfg(mod, token=TOKEN, **kw):
    return mod.ReplicaConfig(bind_host="127.0.0.1",
                             advertise_host="127.0.0.1", token=token, **kw)


def _managers(mod, n, r=1, peers=True, **kw):
    """``n`` managers of ``mod`` (the port's or JAX's replica module), each
    with every other one's address."""
    mgrs = [mod.ReplicaManager(i, n, config=_cfg(mod, num_replicas=r, **kw))
            for i in range(n)]
    if peers:
        for m in mgrs:
            m._peers.update({o.process_index: o.addr for o in mgrs})
    return mgrs


def _leaves(seed=0, step_scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(6, 8, generator=gen) * step_scale
    b = torch.randn(8, generator=gen).to(torch.bfloat16)
    n = torch.tensor(7, dtype=torch.int32)
    return [core.Leaf(p, core.dtype_name(t.dtype), list(t.shape),
                      [core.Shard([[0, d] for d in t.shape], t)])
            for p, t in (("params/w", w), ("params/b", b), ("step", n))]


def _fresh(leaves):
    return [core.Leaf(x.path, x.dtype, x.global_shape,
                      [core.Shard(s.index, torch.zeros_like(s.tensor))
                       for s in x.shards]) for x in leaves]


def _values(leaves):
    return {x.path: x.shards[0].tensor.clone() for x in leaves}


def _same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k].view(-1).view(torch.uint8),
                           want[k].view(-1).view(torch.uint8)), k


def _stage(step, leaves, name=None):
    """A segment holding a pack of ``leaves`` at ``step``: its meta."""
    entries, payload = core.plan_pack(leaves)
    header = core.header_bytes(step, entries, {"dir": "/ckpt"})
    total = core.pack_size(header, payload)
    shm = create_shared_memory(name or shm_name(step), total)
    buf = torch.frombuffer(shm.buf, dtype=torch.uint8)
    used = core.write_pack(buf, leaves, entries, header)
    del buf
    shm.close()
    return {"shm": name or shm_name(step), "used": used, "step": step}


def _segment_bytes(meta):
    shm = attach_shared_memory(meta["shm"])
    try:
        return bytes(shm.buf[: meta["used"]])
    finally:
        shm.close()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_the_port_and_jax_rings_interoperate(direction):
    src_mod, dst_mod = ((replica, jrep) if direction == "port_to_jax"
                        else (jrep, replica))
    holder = dst_mod.ReplicaManager(0, 2, config=_cfg(dst_mod))
    sender = src_mod.ReplicaManager(1, 2, peers={0: holder.addr},
                                    config=_cfg(src_mod))
    try:
        meta = _stage(4, _leaves())
        assert sender.backup(meta) == 1
        assert holder.local_steps() == {1: 4}
        assert sender.peer_steps(0) == {1: 4}
        step, pack, who = sender.fetch(step=4, with_holder=True)
        assert (step, who) == (4, 0)
        assert bytes(pack) == _segment_bytes(meta)
        # the holder answers its own fetch of rank 1's pack from its store
        got = holder.fetch(src=1)
        assert got[0] == 4 and bytes(got[1]) == _segment_bytes(meta)
    finally:
        sender.close()
        holder.close()


class _Stub:
    """What the JAX ``fetch`` reads of a manager: its rank, world and
    config; it records the holders asked, in order."""

    def __init__(self, mod, i, n, r):
        self.process_index, self.process_count = i, n
        self.config = _cfg(mod, num_replicas=r)
        self.asked = []
        self._store = self

    def get(self, src):  # the own store
        self.asked.append(self.process_index)

    def _resolve(self, rank):
        self.asked.append(rank)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_targets_and_holders_equal_jax(n, r):
    for i in range(n):
        jstub = _Stub(jrep, i, n, r)
        want_targets = jrep.ReplicaManager._backup_targets(jstub)
        port = replica.ReplicaManager(
            i, n, config=_cfg(replica, num_replicas=r), serve=False)
        assert port._backup_targets() == want_targets
        for src in range(n):
            jstub.asked.clear()
            assert jrep.ReplicaManager.fetch(jstub, src=src) is None
            assert port.holders(src) == jstub.asked
        # every holder of a rank's pack is one it backs up to
        assert port.holders(i) == want_targets


def test_the_store_keeps_the_latest_step_within_its_budget():
    runs = []
    for mod in (replica, jrep):
        st = mod._ReplicaStore(max_bytes=100)
        runs.append([
            st.put(0, 3, b"a" * 40), st.put(0, 2, b"b" * 40),  # stale
            st.put(0, 3, b"c" * 40), st.put(1, 1, b"d" * 50),
            st.put(2, 1, b"e" * 20),  # over the budget: dropped
            st.put(0, 5, b"f" * 50), st.steps(),
            bytes(st.get(0)[1]), st.get(2)])
        st.drop(1)
        runs[-1].append(st.steps())
    assert runs[0] == runs[1]
    assert runs[0][-1] == {0: 5}


def test_a_pack_past_the_frame_cap_moves_on_the_port_ring_only(
        monkeypatch):
    """The sockets cap a frame at ``MAX_FRAME_BYTES`` (2 GiB); the JAX ring
    reads every payload under it and so refuses a larger pack (llama-1.4b
    at 2 layers packs 2.81 GB), where the port's reads up to the store's
    budget. Shown with the cap set to 4 KiB and a 16 KiB pack."""
    from dlrover_tpu.common import sockets as jsock
    from dlrover_tpu_torch.common import sockets as psock

    for mod in (jsock, psock):
        monkeypatch.setattr(mod.recv_exact, "__defaults__", (4096,))
    big = torch.randn(64, 64, generator=torch.Generator().manual_seed(9))
    leaves = [core.Leaf("params/w", "float32", [64, 64],
                        [core.Shard([[0, 64], [0, 64]], big)])]
    meta = _stage(2, leaves)
    assert meta["used"] > 4 * 4096
    held = {}
    for mod in (jrep, replica):
        holder, sender = _managers(mod, 2)
        try:
            sender.backup(meta)
            got = sender.fetch()
            held[mod.__name__.split(".")[0]] = (
                holder.local_steps(), got and bytes(got[1]))
        finally:
            sender.close()
            holder.close()
    assert held["dlrover_tpu"] == ({}, None)
    assert held["dlrover_tpu_torch"] == ({1: 2}, _segment_bytes(meta))


@pytest.mark.parametrize("mod", [replica, jrep], ids=["port", "jax"])
def test_a_wrong_token_is_refused_before_any_frame(mod):
    holder = mod.ReplicaManager(0, 2, config=_cfg(mod))
    stranger = replica.ReplicaManager(1, 2, peers={0: holder.addr},
                                      config=_cfg(replica, token="wrong"),
                                      serve=False)
    friend = replica.ReplicaManager(1, 2, peers={0: holder.addr},
                                    config=_cfg(replica), serve=False)
    try:
        assert not stranger._put(holder.addr, 3, b"x" * 64)
        assert holder.local_steps() == {}
        assert stranger.peer_steps(0) == {}
        assert friend._put(holder.addr, 3, b"x" * 64)
        assert friend.peer_steps(0) == {1: 3}
        assert stranger.fetch() is None
        assert friend.fetch() == (3, bytearray(b"x" * 64))
    finally:
        holder.close()


def test_fetch_with_exclude_and_holder_equals_jax():
    """n 4, two replicas: rank 0's holders are 1 and 2, which hold
    different steps of it; the same calls on both packages' rings."""
    answers = []
    for mod in (replica, jrep):
        mgrs = _managers(mod, 4, r=2)
        try:
            mgrs[1]._store.put(0, 5, bytearray(b"one"))
            mgrs[2]._store.put(0, 6, bytearray(b"two"))
            m = mgrs[0]
            answers.append([
                m.fetch(), m.fetch(with_holder=True),
                m.fetch(exclude=(1,), with_holder=True),
                m.fetch(step=6, with_holder=True),
                m.fetch(step=7), m.fetch(exclude=(1, 2)),
                mgrs[3].fetch(src=0, with_holder=True),
            ])
        finally:
            for x in mgrs:
                x.close()
    assert answers[0] == answers[1]
    assert answers[0][2] == (6, bytearray(b"two"), 2)


# ---- the engine's replica tier ---------------------------------------------


class _Master:
    """The master client calls the engine and the ring make."""

    def __init__(self, min_step=0):
        self.min_step = min_step
        self.kv = {}

    def report_ckpt_step(self, step, rank=None):
        return True

    def get_min_ckpt_step(self):
        return self.min_step

    def kv_store_set(self, key, value):
        self.kv[key] = value

    def kv_store_get(self, key):
        return self.kv.get(key, "")


def _ring(n=2, r=1, client=None):
    """Stores of ranks 0..n-2 and rank n-1's manager (the staging rank)."""
    mgrs = [replica.ReplicaManager(i, n, master_client=client,
                                   config=_cfg(replica, num_replicas=r))
            for i in range(n)]
    if client is None:
        for m in mgrs:
            m._peers.update({o.process_index: o.addr for o in mgrs})
    return mgrs


def _restore(d, leaves, mgr=None, client=None, **kw):
    fresh = _fresh(leaves)
    eng = CheckpointEngine(d, use_agent=False, replica=mgr,
                           master_client=client)
    got = eng.load(fresh, **kw)
    rec = eng.timings[-1]
    eng.close()
    return got, rec, _values(fresh)


def _rank_manager(mgrs, client=None):
    """A replacement's manager of the last rank (no store of its own)."""
    last = mgrs[-1]
    m = replica.ReplicaManager(last.process_index, last.process_count,
                               peers=None if client else dict(last._peers),
                               master_client=client, config=last.config,
                               serve=False)
    return m


def test_the_engine_restores_memory_then_replica_then_storage(tmp_path):
    d = str(tmp_path / "ckpt")
    mgrs = _ring()
    try:
        leaves = _leaves(seed=1)
        eng = CheckpointEngine(d, use_agent=False, replica=mgrs[1])
        assert eng.save_to_storage(2, leaves)
        assert eng.wait_for_persist(60)
        mgrs[1].wait_backup()
        at2 = _values(leaves)
        leaves3 = _leaves(seed=2)
        assert eng.save_to_memory(3, leaves3)
        mgrs[1].wait_backup()
        at3 = _values(leaves3)
        assert mgrs[0].local_steps() == {1: 3}
        eng._close_segment()

        got, rec, vals = _restore(d, leaves, _rank_manager(mgrs))
        assert (got, rec["tier"]) == (3, "memory")
        _same(vals, at3)
        assert CheckpointEngine.unlink_segment()  # the host is replaced
        got, rec, vals = _restore(d, leaves, _rank_manager(mgrs))
        assert (got, rec["tier"], rec["holder"]) == (3, "replica", 0)
        assert rec["fetch_nbytes"] == mgrs[0]._store.get(1)[1].__len__()
        _same(vals, at3)
        mgrs[0]._store.drop(1)  # the holder lost it too
        got, rec, vals = _restore(d, leaves, _rank_manager(mgrs))
        assert (got, rec["tier"]) == (2, "storage")
        _same(vals, at2)
    finally:
        for m in mgrs:
            m.close()


def test_a_corrupt_holder_makes_the_tier_try_the_next(tmp_path):
    """n 3, two replicas: rank 2's holders are 0 and 1; holder 0's copy
    is cut short, holder 1's is whole."""
    d = str(tmp_path / "ckpt")
    mgrs = _ring(n=3, r=2)
    try:
        leaves = _leaves(seed=3)
        meta = _stage(5, leaves, name=shm_name(2))
        assert mgrs[2].backup(meta) == 2
        whole = mgrs[0]._store.get(2)[1]
        mgrs[0]._store.drop(2)
        mgrs[0]._store.put(2, 5, bytearray(whole[: len(whole) // 2]))
        CheckpointEngine.unlink_segment(2)
        got, rec, vals = _restore(d, leaves, _rank_manager(mgrs))
        assert (got, rec["tier"], rec["holder"]) == (5, "replica", 1)
        _same(vals, _values(leaves))
    finally:
        for m in mgrs:
            m.close()


def test_the_master_minimum_step_pins_the_replica_tier(tmp_path):
    """The holder has step 4 of this rank, the cluster's minimum staged
    step is 2 (another rank skipped step 4's save): the tier restores
    nothing, and the committed step 2 comes from storage. Without the
    pin the tier would have taken step 4, one step past the others."""
    d = str(tmp_path / "ckpt")
    client = _Master(min_step=2)
    mgrs = _ring(client=client)
    try:
        eng = CheckpointEngine(d, use_agent=False, replica=mgrs[1])
        leaves = _leaves(seed=4)
        assert eng.save_to_storage(2, leaves)
        assert eng.wait_for_persist(60)
        mgrs[1].wait_backup()
        at2 = _values(leaves)
        assert eng.save_to_memory(4, _leaves(seed=5))
        mgrs[1].wait_backup()
        assert mgrs[0].local_steps() == {1: 4}
        eng._close_segment()
        CheckpointEngine.unlink_segment()
        got, rec, vals = _restore(d, leaves, _rank_manager(mgrs, client),
                                  client)
        assert (got, rec["tier"]) == (2, "storage")
        _same(vals, at2)
        assert _rank_manager(mgrs, client).fetch()[0] == 4  # unpinned
        client.min_step = 4
        got, rec, _ = _restore(d, leaves, _rank_manager(mgrs, client),
                               client)
        assert (got, rec["tier"]) == (4, "replica")
    finally:
        for m in mgrs:
            m.close()


def test_a_tree_mismatch_in_the_replica_tier_reraises(tmp_path):
    d = str(tmp_path / "ckpt")
    mgrs = _ring()
    try:
        leaves = _leaves(seed=6)
        # the pack lacks the (non-parameter) step leaf
        assert mgrs[1].backup(_stage(3, leaves[:2], name=shm_name(0))) == 1
        CheckpointEngine.unlink_segment()
        with pytest.raises(core.RestoreMismatchError):
            _restore(d, leaves, _rank_manager(mgrs))
        got, rec, _ = _restore(d, leaves, _rank_manager(mgrs), partial=True)
        assert (got, rec["tier"]) == (3, "replica")
    finally:
        for m in mgrs:
            m.close()


def test_a_backup_of_a_pack_being_written_sends_nothing():
    """The header length is written last (after the card's copies): a
    segment whose length reads 0, or holds another step, is not sent."""
    mgrs = _ring()
    try:
        meta = _stage(3, _leaves())
        assert mgrs[1].backup(dict(meta, step=4)) == 0
        shm = attach_shared_memory(meta["shm"])
        shm.buf[: core.HEADER_LEN_BYTES] = bytes(core.HEADER_LEN_BYTES)
        shm.close()
        assert mgrs[1].backup(meta) == 0
        assert mgrs[0].local_steps() == {}
    finally:
        for m in mgrs:
            m.close()


def test_a_replica_restore_equals_the_jax_engines_bit_for_bit(tmp_path):
    """The port stages and backs up a pack; the port engine and the JAX
    engine each restore it through their replica tier from the port's
    store."""
    mgrs = _ring()
    jmgr = jrep.ReplicaManager(1, 2, peers={0: mgrs[0].addr},
                               config=_cfg(jrep))
    try:
        leaves = _leaves(seed=7)
        assert mgrs[1].backup(_stage(6, leaves, name=shm_name(0))) == 1
        CheckpointEngine.unlink_segment()
        got, rec, vals = _restore(str(tmp_path / "p"), leaves,
                                  _rank_manager(mgrs))
        assert (got, rec["tier"]) == (6, "replica")
        jeng = jengine.CheckpointEngine(str(tmp_path / "j"), use_agent=False,
                                        replica=jmgr)
        template = {"params": {"b": jax.ShapeDtypeStruct((8,),
                                                         jnp.bfloat16),
                               "w": jax.ShapeDtypeStruct((6, 8),
                                                         jnp.float32)},
                    "step": jax.ShapeDtypeStruct((), jnp.int32)}
        state = jeng.load(template)
        for path, arr in (("params/w", state["params"]["w"]),
                          ("params/b", state["params"]["b"]),
                          ("step", state["step"])):
            a = np.asarray(arr)
            want = vals[path]
            if want.dtype == torch.bfloat16:
                want, a = want.view(torch.int16), a.view(np.int16)
            np.testing.assert_array_equal(a, want.numpy())
    finally:
        jmgr.close()
        for m in mgrs:
            m.close()


# ---- where the store lives ---------------------------------------------------


def test_a_jax_store_dies_with_its_worker():
    """The reference finding: the JAX ``Checkpointer`` builds its
    ``ReplicaManager`` in the worker, so the holder's worker restart (which
    a node loss forces on every survivor) closes the store that holds the
    lost rank's pack; the replacement's fetch finds nothing."""
    holder, lost = _managers(jrep, 2)
    meta = _stage(4, _leaves())
    assert lost.backup(meta) == 1 and holder.local_steps() == {1: 4}
    peers = dict(lost._peers)
    lost.close()
    holder.close()  # the holder's worker restarts
    replacement = jrep.ReplicaManager(1, 2, peers=peers, config=_cfg(jrep))
    try:
        assert replacement.fetch() is None
    finally:
        replacement.close()


def test_the_port_store_lives_in_the_agent_across_worker_restarts():
    """The port's agent (``AsyncCheckpointSaver``) runs the store of its
    worker's ring slot: a new worker of the same slot keeps it, and the
    lost rank's replacement fetches from it."""
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

    client = _Master()
    saver = AsyncCheckpointSaver(master_client=client)
    lost = replica.ReplicaManager(1, 2, master_client=client,
                                  config=_cfg(replica))
    try:
        event = {"type": "replica", "local_rank": 0, "rank": 0, "world": 2,
                 "num_replicas": 1, "max_store_bytes": 1 << 30}
        saver._serve_replica(event)
        store = saver.replicas[0]
        meta = _stage(4, _leaves())
        assert lost.backup(meta) == 1
        saver._serve_replica(event)  # the holder's worker restarted
        assert saver.replicas[0] is store
        assert store.local_steps() == {1: 4}
        lost.close()
        new = replica.ReplicaManager(1, 2, master_client=client,
                                     config=_cfg(replica), serve=False)
        got = new.fetch(with_holder=True)
        assert got[0] == 4 and got[2] == 0
        assert bytes(got[1]) == _segment_bytes(meta)
        # a new ring slot (another world) gets a new store
        saver._serve_replica(dict(event, world=3))
        assert saver.replicas[0] is not store
    finally:
        saver.close()


def test_the_agent_backs_up_a_staged_pack_under_the_workers_lock():
    """A worker's ``{"type": "backup"}`` event: the agent copies the
    staged segment under that worker's lock (a worker that holds the lock
    delays it) and sends it to the ring successor."""
    from dlrover_tpu_torch.checkpoint.saver import (
        AsyncCheckpointSaver,
        meta_key,
    )

    client = _Master()
    holder = replica.ReplicaManager(0, 2, master_client=client,
                                    config=_cfg(replica))
    saver = AsyncCheckpointSaver(master_client=client)
    try:
        saver._serve_replica({"type": "replica", "local_rank": 0, "rank": 1,
                              "world": 2, "num_replicas": 1,
                              "max_store_bytes": 1 << 30})
        meta = _stage(6, _leaves(), name=shm_name(1))
        saver.meta.set(meta_key(0), meta)
        assert saver.shm_locks[0].acquire(owner="pid-worker")
        saver._backup({"type": "backup", "local_rank": 0, "step": 6})
        threading.Event().wait(0.3)
        assert holder.local_steps() == {}  # waiting for the worker's lock
        saver.shm_locks[0].release(owner="pid-worker")
        saver.replicas[0].wait_backup(30)
        assert holder.local_steps() == {1: 6}
        assert bytes(holder._store.get(1)[1]) == _segment_bytes(meta)
        # an event of an older step than the one staged sends nothing
        saver._backup({"type": "backup", "local_rank": 0, "step": 4})
        assert saver.replicas[0]._backup_thread is not None
    finally:
        saver.close()
        holder.close()
