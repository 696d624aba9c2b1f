"""The port's job master against the JAX package's, on the CPU.

One scripted session of client calls (register, heartbeats, join, the
sealed comm world, nodes waiting, the KV store, a sync barrier, the
global step, checkpoint steps and their minimum, model info, the
running nodes, the parallel config, a tuning directive and its version,
the sparse tier's versions, a status report) runs against the JAX ``LocalJobMaster``
with its ``MasterClient`` (gRPC), then against the port's pair (the
standard-library transport), both in-process. Every reply is the same.
The port's master also ends its supervision loop as the JAX one does
when its only worker reports success, and its CLI prints the address
the JAX one prints.
"""

import dataclasses
import subprocess
import sys
import time

import pytest

from dlrover_tpu.agent.master_client import MasterClient as JClient
from dlrover_tpu.master.master import LocalJobMaster as JMaster
from dlrover_tpu_torch.agent.master_client import MasterClient as TClient
from dlrover_tpu_torch.master.master import LocalJobMaster as TMaster


def _plain(value):
    """Replies as plain data (the two packages' dataclasses differ)."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def _session(master_cls, client_cls):
    master = master_cls(port=0, num_workers=1)
    master.prepare()
    try:
        c = client_cls(master.addr, node_id=0)
        out = [("register", c.register_node(local_chips=2))]
        out.append(("heartbeat", c.report_heartbeat()))
        out.append(("actions", c.heartbeat_with_actions()))
        out.append(("join", c.join_rendezvous(2)))
        world = (-1, 0, {}, "")
        deadline = time.time() + 30
        while not world[2] and time.time() < deadline:
            world = c.get_comm_world()
        out.append(("world", world[:3], world[3].rsplit(":", 1)[1]))
        out.append(("waiting", c.num_nodes_waiting()))
        out.append(("kv_set", c.kv_store_set("k", "v1")))
        out.append(("kv_get", c.kv_store_get("k"), c.kv_store_get("nope")))
        out.append(("sync_before", c.sync_finished("s")))
        out.append(("sync_join", c.join_sync("s")))
        out.append(("sync_after", c.sync_finished("s")))
        out.append(("step", c.report_global_step(7, 1)))
        out.append(("speed", master.speed_monitor.global_step))
        out.append(("ckpt_none", c.get_min_ckpt_step()))
        out.append(("ckpt", c.report_ckpt_step(4)))
        out.append(("ckpt_min", c.get_min_ckpt_step()))
        out.append(("model", c.report_model_info(
            model_name="llama", num_params=12, flops_per_token=3.5,
            seq_len=64)))
        out.append(("running", [(n.id, n.type, n.name, n.status,
                                 n.rank_index) for n in c.get_running_nodes()]))
        out.append(("config", c.get_parallel_config()))
        out.append(("tuning_none", c.get_tuning()))
        out.append(("tune", c.report_tuning_plan(
            '{"batch_size": 2}', signal="oom", reason="oom")))
        out.append(("tuning", c.get_tuning(), c.get_parallel_config()))
        out.append(("ps", c.get_ps_version(), c.bump_ps_version(),
                    c.report_ps_node_version(4), c.get_ps_version(),
                    c.get_ps_version("node")))
        out.append(("succeeded", c.report_node_status("succeeded")))
        out.append(("exited", master.job_manager.all_workers_succeeded()))
        return [_plain(x) for x in out]
    finally:
        master.stop()


def test_a_client_session_gets_the_jax_masters_replies():
    theirs = _session(JMaster, JClient)
    mine = _session(TMaster, TClient)
    assert mine == theirs
    assert dict((x[0], x[1:]) for x in mine)["world"][0][2] == {0: 2}


def test_the_model_info_lands_in_the_masters_job_meta():
    master = TMaster(port=0, num_workers=1)
    master.prepare()
    try:
        c = TClient(master.addr, node_id=0)
        c.report_model_info(model_name="m", num_params=5)
        c.report_model_info(seq_len=9)  # a partial update keeps the rest
        meta = master.metric_collector.meta
        assert (meta.model_name, meta.num_params, meta.seq_len) == (
            "m", 5, 9)
    finally:
        master.stop()


def test_the_supervision_loop_ends_when_the_worker_succeeds():
    master = TMaster(port=0, num_workers=1)
    master.prepare()
    c = TClient(master.addr, node_id=0)
    c.register_node(local_chips=1)
    c.report_node_status("succeeded")
    assert master.run(poll_interval_s=0.05) == "succeeded"


def test_the_master_cli_prints_its_address():
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.master.main",
         "--num-workers", "1"], stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("DLROVER_TPU_MASTER_ADDR=localhost:")
        c = TClient(line.split("=", 1)[1], node_id=0)
        c.register_node(local_chips=1)
        c.report_node_status("succeeded")
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_cluster_mode_waits_for_its_item():
    """Cluster mode came with the planning loop: ``--optimize-mode
    cluster --brain-addr`` builds a ``BrainClient`` as the auto-scaler's
    optimizer, ``max_workers > num_workers`` builds a ``JobAutoScaler``
    (over the local heuristic without a Brain), an equal range builds
    none (cluster mode then consults no Brain, as the JAX master), and
    cluster mode without an address is refused before any port binds."""
    from dlrover_tpu_torch.cluster.brain import BrainClient
    from dlrover_tpu_torch.master import main
    from dlrover_tpu_torch.master.auto_scaler import JobAutoScaler
    from dlrover_tpu_torch.master.resource_optimizer import (
        LocalHeuristicOptimizer,
    )

    args = main.parse_master_args(["--optimize-mode", "cluster",
                                   "--brain-addr", "localhost:1",
                                   "--num-workers", "1", "--max-workers",
                                   "2", "--job-kind", "gpt"])
    built = []
    for kw in (dict(num_workers=1, max_workers=2, optimize_mode="cluster",
                    brain_addr=args.brain_addr, job_kind=args.job_kind),
               dict(num_workers=1, max_workers=3),
               dict(num_workers=2, max_workers=2, optimize_mode="cluster",
                    brain_addr="localhost:1")):
        master = main.DistributedJobMaster(**kw)
        try:
            built.append(master.auto_scaler)
        finally:
            master.stop()
    assert isinstance(built[0], JobAutoScaler)
    assert isinstance(built[0].optimizer, BrainClient)
    assert (built[0].min_workers, built[0].max_workers) == (1, 2)
    assert isinstance(built[1].optimizer, LocalHeuristicOptimizer)
    assert built[2] is None
    with pytest.raises(ValueError, match="brain_addr"):
        main.run(main.parse_master_args(["--optimize-mode", "cluster"]))
