"""The torchrun-style elastic launcher
(``python -m dlrover_tpu_torch.agent.launcher``).

Port of ``dlrover_tpu/agent/launcher.py`` (reference:
dlrover/trainer/torch/elastic_run.py: parse_args:125, run:342,
_launch_dlrover_local_master:237). A single-node run starts an
in-process ``LocalJobMaster``; multi-node runs point every node's agent
at the job master (``--master-addr``, see ``master/main.py``). The
agent serves Flash Checkpoint's brokers (``AsyncCheckpointSaver``, with
the replica ring's stores) to its workers, one a local GPU
(``--nproc``, default: every GPU), and unlinks their staging segments
when it exits, but for a relaunch (exit code 2: the segments stay for
whatever the platform does with the host). The resource monitor
(``monitor.py``) reports the node's CPU, memory and card memory to the
master, as the JAX launcher's does. The heartbeat interval is the
context's (``DLROVER_TPU_CTX_HEARTBEAT_INTERVAL_S``). At exit the
launcher logs its process's peak resident set (``peak_rss_bytes``).
``--network-check`` runs the node check (``node_check.py``: a bf16
matmul chain on the node's GPU and an all-reduce over its GPUs) in two
rounds of the master's network-check rendezvous before training, and
the node exits 3 (``check_failed``) when the master finds it faulty or,
with ``--exclude-straggler``, a straggler; a node without a GPU fails
the check. ``--comm-perf-test`` logs the all-reduce bandwidth over the
node's GPUs.

Usage:
    python -m dlrover_tpu_torch.agent.launcher --nnodes 1 --nproc 1 \
        --max-restarts 1 -- python -m \
        dlrover_tpu_torch.examples.train_gpt_elastic --steps 10
"""

import argparse
import os
import sys
import threading
import time
from typing import List, Optional

from dlrover_tpu_torch.agent.agent import (
    ElasticLaunchConfig,
    ElasticTrainingAgent,
)
from dlrover_tpu_torch.agent.config_tuner import ParalConfigTuner
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.monitor import ResourceMonitor, peak_rss_bytes
from dlrover_tpu_torch.agent.node_check import (
    run_comm_perf_test,
    run_node_check,
)
from dlrover_tpu_torch.agent.rendezvous import MasterRendezvousHandler
from dlrover_tpu_torch.common.constants import (
    GraftEnv,
    NodeStatus,
    RendezvousName,
)
from dlrover_tpu_torch.common.global_context import get_context
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="dlrover-tpu-torch-run")
    p.add_argument(
        "--nnodes",
        default="1",
        help="N or MIN:MAX node count (elastic range)",
    )
    p.add_argument("--node-id", type=int, default=None)
    p.add_argument(
        "--nproc",
        type=int,
        default=0,
        help="workers on this node, one a GPU (0 = every local GPU)",
    )
    p.add_argument("--master-addr", default="", help="job master host:port")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument(
        "--network-check",
        action="store_true",
        help="run the matmul+collective health check on the node's GPUs "
        "before training",
    )
    p.add_argument(
        "--comm-perf-test",
        action="store_true",
        help="sweep allreduce sizes across the node's GPUs and log bus "
        "bandwidth before training (reference: dlrover-run "
        "--comm-perf-test)",
    )
    p.add_argument(
        "--exclude-straggler",
        action="store_true",
        help="with --network-check: a node the check flags as a "
        "straggler exits instead of joining (and slowing) the world "
        "(reference: dlrover-run --exclude-straggler)",
    )
    p.add_argument("--node-unit", type=int, default=1)
    p.add_argument(
        "--optimize-mode",
        default="single-job",
        choices=["single-job", "cluster"],
        help="the local master's auto-scaler plans from its own heuristic "
        "(single-job) or from a shared Brain (cluster)",
    )
    p.add_argument(
        "--brain-addr",
        default="",
        help="host:port of the Brain service (optimize-mode=cluster)",
    )
    p.add_argument("--monitor-interval", type=float, default=2.0)
    p.add_argument("entrypoint", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.entrypoint and args.entrypoint[0] == "--":
        args.entrypoint = args.entrypoint[1:]
    return args


def _parse_nnodes(spec: str):
    if ":" in spec:
        lo, hi = spec.split(":")
        return int(lo), int(hi)
    return int(spec), int(spec)


def _detect_local_chips() -> int:
    """Local GPUs (NVML's count: no CUDA context in the agent); a node
    without one runs one CPU worker."""
    import torch

    return torch.cuda.device_count() or 1


def _launch_local_master(num_workers: int, max_workers: int, node_unit: int,
                         optimize_mode: str = "single-job",
                         brain_addr: str = ""):
    """Spin an in-process LocalJobMaster (reference: :237); returns it and
    the thread of its supervision loop."""
    from dlrover_tpu_torch.master.master import LocalJobMaster

    master = LocalJobMaster(
        port=0,
        num_workers=num_workers,
        max_workers=max_workers,
        node_unit=node_unit,
        optimize_mode=optimize_mode,
        brain_addr=brain_addr,
    )
    master.prepare()
    thread = threading.Thread(
        target=master.run, name="local-master", daemon=True
    )
    thread.start()
    logger.info("local master started at %s", master.addr)
    return master, thread


def _stop_local_master(master, thread, timeout_s: float = 30.0) -> None:
    """Stop the local master and wait for its loop to end: its stop (the
    dataset summary it logs, its endpoint and transport closed) finishes
    before the launcher's process can exit under it."""
    master.request_stop()
    thread.join(timeout_s)


def _run_network_check(client: MasterClient,
                       config: ElasticLaunchConfig) -> int:
    """Two paired check rounds; 3 if this node is declared faulty (or a
    straggler under ``--exclude-straggler``), else 0."""
    for _ in range(2):
        handler = MasterRendezvousHandler(
            client,
            client.node_rank,
            config.local_chips,
            rdzv_name=RendezvousName.NETWORK_CHECK,
            timeout_s=config.rdzv_timeout_s,
        )
        handler.next_rendezvous()
        ok, elapsed = run_node_check()
        client.report_network_check_result(elapsed, ok)
        time.sleep(1.0)
    status = client.get_network_check_status()
    logger.info("network check status: normal=%s faults=%s stragglers=%s",
                status.normal, status.fault_nodes, status.stragglers)
    if not status.normal:
        logger.error(
            "this node failed the network check (faults=%s); exiting",
            status.fault_nodes,
        )
        client.report_node_status(NodeStatus.CHECK_FAILED)
        return 3
    if status.stragglers:
        logger.warning("stragglers detected: %s", status.stragglers)
        if (
            config.exclude_straggler
            and client.node_rank in status.stragglers
        ):
            logger.error(
                "this node is a straggler and --exclude-straggler is "
                "set; exiting"
            )
            client.report_node_status(NodeStatus.CHECK_FAILED)
            return 3
    return 0


def run(args: argparse.Namespace, config_interval_s: float = 30.0) -> int:
    """Run this node's agent. Without ``--master-addr`` it starts a local
    master; ``config_interval_s`` is the ``ParalConfigTuner``'s poll
    period."""
    min_nodes, max_nodes = _parse_nnodes(args.nnodes)
    node_id = (
        args.node_id
        if args.node_id is not None
        else int(os.environ.get(GraftEnv.NODE_ID, "0"))
    )
    if os.environ.get(GraftEnv.TRACE_DIR):
        # flight recorder on: this process's failover spans stream as
        # role=agent (workers it spawns stream as role=worker)
        from dlrover_tpu_torch.observability.tracing import configure_tracer

        configure_tracer("agent")
    local_chips = args.nproc or _detect_local_chips()

    config = ElasticLaunchConfig(
        min_nodes=min_nodes,
        max_nodes=max_nodes,
        node_id=node_id,
        local_chips=local_chips,
        max_restarts=args.max_restarts,
        monitor_interval_s=args.monitor_interval,
        heartbeat_interval_s=get_context().heartbeat_interval_s,
        network_check=args.network_check,
        comm_perf_test=args.comm_perf_test,
        exclude_straggler=args.exclude_straggler,
        node_unit=args.node_unit,
        entrypoint=args.entrypoint,
    )
    config.auto_configure()
    if not config.entrypoint:
        logger.error("no training entrypoint given")
        return 2

    master = None
    master_addr = args.master_addr or os.environ.get(GraftEnv.MASTER_ADDR, "")
    if not master_addr:
        if min_nodes > 1:
            logger.error("multi-node runs need --master-addr")
            return 2
        master, master_thread = _launch_local_master(
            min_nodes, max_nodes, args.node_unit, args.optimize_mode,
            args.brain_addr)
        master_addr = master.addr
        # one node: its workers' store is on this host
        os.environ.setdefault("DLROVER_TPU_HOST_ADDR", "localhost")

    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

    saver = monitor = tuner = None
    rc = 1
    try:
        client = MasterClient(master_addr, node_id=node_id)
        client.register_node(local_chips=config.local_chips)
        monitor = ResourceMonitor(client)
        monitor.start()
        tuner = ParalConfigTuner(client, interval_s=config_interval_s)
        tuner.start()
        if config.network_check:
            check_rc = _run_network_check(client, config)
            if check_rc:
                rc = check_rc
                return rc
        if config.comm_perf_test:
            try:
                run_comm_perf_test()
            except Exception:  # noqa: BLE001 — diagnostic, never fatal
                logger.warning("comm perf test failed", exc_info=True)
        agent = ElasticTrainingAgent(config, client)
        saver = AsyncCheckpointSaver.start_async_saving_ckpt(
            config.local_chips, master_client=client)
        agent.attach_ckpt_saver(saver)
        rc = agent.run()
        return rc
    finally:
        if monitor is not None:
            monitor.stop()
        if tuner is not None:
            tuner.stop()
        if saver is not None:
            saver.close(unlink=rc != 2)
        if master is not None:
            _stop_local_master(master, master_thread)
        logger.info("agent of node %d exits (rc %d): peak_rss_bytes=%d",
                    node_id, rc, peak_rss_bytes())


def main(argv: Optional[List[str]] = None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
