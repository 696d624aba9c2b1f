"""The port's dynamic data sharding against the JAX package.

- ``master/dataset_splitter.py``: the shard sequence (and, for a seed,
  the shuffle) of the table, text and streaming splitters equals the JAX
  splitters'.
- ``master/task_manager.py``: the dispatch order equals the JAX
  ``TaskManager``'s; WAIT while every shard is in flight; a dead
  worker's and a timed-out shard re-queued first; the dataset checkpoint
  is the JAX one's JSON string, and a restore dispatches what the JAX
  restore dispatches.
- The master's handlers end to end: the port's ``LocalJobMaster`` on its
  transport, ``MasterClient`` and ``ShardingClient`` (dataset params,
  tasks, results, the checkpoint, the epoch, a failed node's shards
  re-queued, the eviction notice and the reshard directive).
- ``ShardingClient``'s queue of fetched shards: a loop that fetches
  ahead reports the oldest first, and the checkpoint then holds the
  fetched, unreported shards in flight.
- ``iter_shards_spmd`` over 2 gloo processes (``torch_zero_worker.py``):
  both ranks see the same sequence, every shard once.
"""

import json
import os
import time

import pytest

import torch_sp_worker  # noqa: E402
from dlrover_tpu.master import dataset_splitter as jsplit  # noqa: E402
from dlrover_tpu.master import task_manager as jtm  # noqa: E402
from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa: E402
from dlrover_tpu_torch.agent.sharding_client import (  # noqa: E402
    ShardingClient,
)
from dlrover_tpu_torch.common import messages as msgs  # noqa: E402
from dlrover_tpu_torch.master import dataset_splitter as tsplit  # noqa: E402
from dlrover_tpu_torch.master import task_manager as ttm  # noqa: E402
from dlrover_tpu_torch.master.master import LocalJobMaster  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_zero_worker.py")
_KINDS = [("table", False), ("table", True), ("text", False), ("text", True),
          ("stream", False)]


def _shards(splitter, epochs=2):
    out = []
    for _ in range(epochs):
        out.append([(s.name, s.start, s.end, list(s.record_indices))
                    for s in splitter.create_shards()])
    return out


@pytest.mark.parametrize("kind,shuffle", _KINDS)
def test_splitter_sequences_equal_jax(kind, shuffle):
    args = (kind, "ds", 103, 10)
    kw = dict(num_epochs=2, shuffle=shuffle, seed=5)
    mine = tsplit.new_dataset_splitter(*args, **kw)
    ref = jsplit.new_dataset_splitter(*args, **kw)
    assert _shards(mine) == _shards(ref)
    assert mine.epoch_finished() == ref.epoch_finished()


def _dispatch(tm, n, worker=1):
    out = []
    for _ in range(n):
        t = tm.get_task("ds", worker)
        out.append((t.task_id, t.task_type, t.shard.start, t.shard.end,
                    list(t.shard.record_indices), t.epoch))
        if t.task_id >= 0:
            tm.report_task_status("ds", t.task_id, True, worker)
    return out


@pytest.mark.parametrize("kind,shuffle", _KINDS[:4])
def test_task_manager_dispatch_equals_jax(kind, shuffle):
    seqs = []
    for mod in (ttm, jtm):
        tm = mod.TaskManager()
        tm.new_dataset("ds", 55, 10, num_epochs=2, shuffle=shuffle,
                       storage_type=kind)
        seqs.append(_dispatch(tm, 14))
        assert tm.finished()
    assert seqs[0] == seqs[1]
    assert seqs[0][-1][1] == "none"  # past the end: the invalid task


def test_wait_until_in_flight_shards_finish_and_a_death_requeues():
    tm = ttm.TaskManager()
    tm.new_dataset("ds", 20, 10)
    a, b = tm.get_task("ds", 1), tm.get_task("ds", 2)
    assert (a.shard.start, b.shard.start) == (0, 10)
    assert tm.get_task("ds", 3).task_type == "wait"
    tm.recover_worker_tasks(2)  # worker 2 died holding [10, 20)
    c = tm.get_task("ds", 3)
    assert (c.shard.start, c.shard.end) == (10, 20)
    tm.report_task_status("ds", a.task_id, True, 1)
    tm.report_task_status("ds", c.task_id, False, 3)  # failed: back first
    d = tm.get_task("ds", 1)
    assert d.task_id == c.task_id
    tm.report_task_status("ds", d.task_id, True, 1)
    assert tm.get_task("ds", 1).task_type == "none" and tm.finished()


def test_timed_out_shards_are_requeued_as_jax_requeues_them():
    outs = []
    for mod in (ttm, jtm):
        tm = mod.TaskManager()
        tm.new_dataset("ds", 30, 10)
        first = tm.get_task("ds", 1)
        tm.get_task("ds", 1)
        ds = tm._datasets["ds"]
        ds.doing[first.task_id].start_time = time.time() - 100
        n = ds.recover_timeout_tasks(50)
        outs.append((n, [t.shard.start for t in ds.todo]))
    assert outs[0] == outs[1] == (1, [0, 20])


@pytest.mark.parametrize("kind,shuffle", [("table", True), ("stream", False)])
def test_checkpoint_string_and_restore_equal_jax(kind, shuffle):
    ckpts, after = [], []
    for mod in (ttm, jtm):
        tm = mod.TaskManager()
        tm.new_dataset("ds", 60, 10, num_epochs=2, shuffle=shuffle,
                       storage_type=kind)
        _dispatch(tm, 3)
        tm.get_task("ds", 7)  # in flight at the checkpoint
        content = tm.checkpoint("ds")
        ckpts.append(content)
        fresh = mod.TaskManager()
        fresh.new_dataset("ds", 60, 10, num_epochs=2, shuffle=shuffle,
                          storage_type=kind)
        fresh.restore_checkpoint("ds", content)
        after.append(_dispatch(fresh, 6))
    assert ckpts[0] == ckpts[1]
    assert json.loads(ckpts[0])["doing"]
    assert after[0] == after[1]


@pytest.fixture
def master():
    m = LocalJobMaster(port=0, num_workers=1)
    m.prepare()
    yield m
    m.stop()


def test_the_handlers_end_to_end(master):
    client = MasterClient(master.addr, node_id=0, node_rank=0)
    sc = ShardingClient(client, "ds", 40, 10)
    assert sc.get_epoch() == 1
    assert sc.fetch_shard(0.01) == (0, 10, [])
    assert sc.report_shard_done() == (0, 10)
    assert sc.fetch_shard(0.01)[:2] == (10, 20)
    pos = sc.checkpoint()
    assert json.loads(pos)["doing"] == [[10, 20, 1]]
    assert pos == master.task_manager.checkpoint("ds")
    # a planned worker restart re-queues its in-flight shard
    client.report_worker_restart("planned restart")
    assert json.loads(master.task_manager.checkpoint("ds"))["todo"][0] == [
        10, 20, 1]
    assert sc.restore(pos)
    assert sc.fetch_shard(0.01)[:2] == (10, 20)
    # the node fails: its in-flight shard comes back first
    client.report_failure("boom", level="process_error")
    other = MasterClient(master.addr, node_id=1, node_rank=0)
    t = other.get_task("ds")
    assert (t.shard_start, t.shard_end) == (10, 20)
    # a restore puts the dataset back to the checkpoint
    assert sc.restore(pos)
    got = [sc.fetch_shard(0.01)[:2] for _ in range(3)]
    assert got == [(10, 20), (20, 30), (30, 40)]
    for _ in got:
        sc.report_shard_done()
    assert sc.fetch_shard(0.01) is None
    assert master.task_manager.completed_counts() == {"ds": 4}
    # the eviction notice and the reshard directive
    assert client.get_reshard_plan().version == 0
    assert client.report_eviction([2, 3], dp_size=4, reason="drill")
    plan = client.get_reshard_plan()
    assert (plan.version, plan.dp_old, plan.dp_new, plan.lost_ranks) == (
        1, 4, 2, [2, 3])
    assert not client.report_eviction([0, 1], dp_size=2)  # no survivor
    assert master.servicer.unported("TaskRequest") is None


def test_a_fetch_ahead_loop_reports_the_oldest_first(master):
    client = MasterClient(master.addr, node_id=0, node_rank=0)
    sc = ShardingClient(client, "ds", 50, 10)
    ahead = [sc.fetch_shard(0.01)[:2] for _ in range(3)]
    assert ahead == [(0, 10), (10, 20), (20, 30)]
    assert sc.report_shard_done() == (0, 10)  # the step of shard 0 ran
    pos = json.loads(sc.checkpoint())
    assert pos["doing"] == [[10, 20, 1], [20, 30, 1]]
    assert pos["todo"] == [[30, 40, 1], [40, 50, 1]]
    assert not sc.report_batch_done(4)
    assert sc.report_batch_done(6)  # shard [10, 20) consumed
    assert sc.report_shard_done() == (20, 30)
    assert sc.report_shard_done() is None


def test_message_encoding_is_the_jax_packages():
    from dlrover_tpu.common import messages as jmsgs

    for m in (msgs.Task(task_id=3, task_type="training", dataset_name="d",
                        shard_start=1, shard_end=2, record_indices=[5]),
              msgs.EvictionNotice(node_id=1, lost_dp_ranks=[2], dp_size=4),
              msgs.ReshardPlanResponse(version=1, lost_ranks=[3]),
              msgs.DatasetShardParams(dataset_name="d", dataset_size=9)):
        raw = msgs.serialize(m)
        assert jmsgs.serialize(jmsgs.deserialize(raw)) == raw


def test_iter_shards_spmd_over_two_gloo_ranks(master, tmp_path):
    spec = {"addr": master.addr, "name": "spmd", "size": 70, "shard": 10}
    outs = torch_sp_worker.spawn("shards", spec, 2, tmp_path, script=WORKER)
    want = [(s, s + 10) for s in range(0, 70, 10)]
    assert outs[0]["seen"] == outs[1]["seen"] == want
    assert master.task_manager.completed_counts()["spmd"] == 7


def test_the_examples_feed_ends_with_batches_in_flight(master):
    """The elastic example's Trainer feed under a lookahead of 3 batches
    (``prefetch_to_device`` at size 2 on the card), each shard reported
    when its step runs: it ends after the last step instead of waiting on
    the shards it holds."""
    import argparse
    import collections

    from dlrover_tpu_torch.examples.train_gpt_elastic import shard_batches

    client = MasterClient(master.addr, node_id=0, node_rank=0)
    sc = ShardingClient(client, "feed", 6 * 4, 4)
    args = argparse.Namespace(batch=4, steps=6, seed=0, seq=8, masked=False)
    feed = shard_batches(sc, args, 0, 4, 64)
    ahead, trained = collections.deque(), []
    for batch in feed:
        ahead.append(batch)
        if len(ahead) > 2:
            ahead.popleft()
            trained.append(sc.report_shard_done())
    while ahead:
        ahead.popleft()
        trained.append(sc.report_shard_done())
    assert trained == [(s, s + 4) for s in range(0, 24, 4)]
    assert master.task_manager.completed_counts()["feed"] == 6
