"""The network check in the port, on the CPU: the node check
(``agent/node_check.py``), the master's network-check rendezvous
(``master/rdzv_manager.py`` ``NetworkCheckRendezvousManager``) and its
servicer handlers, the master client's two calls, and the launcher's
``--network-check``.

- ``run_node_check(device="cpu")`` passes at a small size, a planted
  error and a node without a GPU give ``(False, 0.0)``; one device makes
  no collective (``0.0``, ``{}``), and the bandwidth sweep's byte
  accounting is the JAX check's;
- the same join, poll and report sequences through the JAX manager and
  the port's give the same rounds, pairings, faulty nodes and
  stragglers, and the two servicers answer the same bytes;
- the launcher's check with an in-process master: a node failing both
  rounds exits 3, so does a straggler under ``--exclude-straggler``
  (without it, it trains), healthy nodes go on; and the launcher's
  command line on a node without a GPU exits 3 before any worker.
"""

import os
import subprocess
import sys
import threading

import pytest
import torch

from dlrover_tpu.agent import node_check as jcheck
from dlrover_tpu.common import messages as jmsgs
from dlrover_tpu.master.rdzv_manager import (
    NetworkCheckRendezvousManager as JNet,
)
from dlrover_tpu.master.servicer import MasterServicer as JServicer
from dlrover_tpu_torch.agent import launcher, node_check
from dlrover_tpu_torch.agent.agent import ElasticLaunchConfig
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import messages as msgs
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.master.master import JobMaster
from dlrover_tpu_torch.master.rdzv_manager import (
    NetworkCheckRendezvousManager as TNet,
)
from dlrover_tpu_torch.master.servicer import MasterServicer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- the node check --------------------------------------------------------


def test_the_node_check_passes_on_the_cpu_when_asked_for():
    ok, elapsed = node_check.run_node_check(device="cpu", size=64, iters=3)
    assert ok and elapsed > 0
    assert node_check.matmul_bench(size=32, iters=2, device="cpu") > 0


@pytest.mark.parametrize("how", ["planted", "no_gpu", "wrong_product"])
def test_a_failing_node_check_gives_false_and_zero(how, monkeypatch):
    kw = {}
    if how == "planted":
        kw = dict(mock_error=True, device="cpu")
    elif how == "no_gpu":  # the card unless asked: no fallback to the CPU
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    else:  # a device whose products are wrong
        real = torch.Tensor.__matmul__
        monkeypatch.setattr(torch.Tensor, "__matmul__",
                            lambda a, b: real(a, b) * 2)
        kw = dict(device="cpu", size=16, iters=2)
    assert node_check.run_node_check(**kw) == (False, 0.0)


def test_one_device_makes_no_collective():
    assert node_check.collective_bench(device="cpu") == 0.0
    assert node_check.run_comm_perf_test(device="cpu") == {}
    assert node_check.local_devices("cpu") == [torch.device("cpu")]


def test_the_bandwidth_sweep_counts_bytes_as_the_jax_check(monkeypatch):
    """With 8 devices and the same collective times, the port's sweep
    reports the JAX sweep's GB/s for each requested size (the ring's
    2(n−1)/n of each device's bf16 buffer, 4 iterations)."""
    secs = {1 << 16: 0.002, 1 << 17: 0.003, 1 << 20: 0.5}
    monkeypatch.setattr(jcheck.jax, "devices", lambda: list(range(8)))
    monkeypatch.setattr(jcheck, "collective_bench",
                        lambda n_elems, iters: secs[n_elems])
    monkeypatch.setattr(node_check, "local_devices",
                        lambda device=None: [torch.device("cpu")] * 8)
    monkeypatch.setattr(node_check, "collective_bench",
                        lambda n_elems, iters, device=None: secs[n_elems])
    sizes = tuple(secs)
    mine = node_check.run_comm_perf_test(sizes=sizes)
    assert mine == jcheck.run_comm_perf_test(sizes=sizes)
    assert mine[1 << 16] == pytest.approx(2 * 7 / 8 * (1 << 13) * 2 * 4
                                          / 0.002 / 1e9)


# ---- the master's network-check rendezvous ---------------------------------

# an op: ("join", rank), ("world", rank), ("report", rank, ok, secs),
# ("next",), ("fault",), ("stragglers", ratio) or ("group", ranks, round)
NET_SCRIPTS = {
    "pairs_then_rotate": [
        ("group", [0, 1, 2, 3], 0), ("group", [0, 1, 2, 3], 1),
        ("group", [0, 1, 2, 3, 4], 0), ("group", [0, 1, 2, 3, 4], 1),
        ("group", [0, 1, 2, 3, 4, 5], 1), ("group", [0, 1], 1),
        ("group", [7], 0)],
    "fault_in_both_rounds": [
        ("report", 0, True, 1.0), ("report", 1, True, 1.0),
        ("report", 3, True, 1.0), ("report", 2, False, 0.0), ("next",),
        ("report", 0, True, 1.0), ("report", 1, True, 1.0),
        ("report", 2, False, 0.0), ("report", 3, False, 0.0), ("fault",)],
    "stragglers": [
        ("report", 0, True, 1.0), ("report", 1, True, 1.0),
        ("report", 2, True, 1.0), ("report", 3, True, 5.0),
        ("stragglers", 1.6), ("stragglers", 10.0), ("fault",)],
    "rounds_through_the_rendezvous": [
        ("join", 0), ("join", 1), ("join", 2), ("join", 3),
        ("world", 0), ("world", 2), ("world", 3),
        ("report", 0, True, 1.0), ("report", 1, True, 1.1),
        ("report", 2, False, 0.0), ("report", 3, True, 1.2),
        ("world", 0), ("join", 0), ("join", 1), ("join", 2), ("join", 3),
        ("world", 0), ("world", 1), ("world", 3),
        ("report", 0, True, 1.0), ("report", 1, True, 1.1),
        ("report", 2, False, 0.0), ("report", 3, True, 4.0),
        ("fault",), ("stragglers", 1.6)],
    "one_node_alone": [
        ("join", 5), ("world", 5), ("report", 5, True, 0.2), ("join", 5),
        ("world", 5), ("report", 5, True, 0.3), ("fault",),
        ("stragglers", 1.6)],
}


def _run_net(mgr, script):
    mgr.update_rdzv_params(min_nodes=1, max_nodes=4, waiting_timeout=0)
    out = []
    for op in script:
        if op[0] == "join":
            out.append(mgr.join_rendezvous(op[1], op[1], 1))
        elif op[0] == "world":
            out.append(mgr.get_comm_world(op[1]))
        elif op[0] == "report":
            mgr.report_network_check_result(*op[1:])
            out.append(mgr._check_round)
        elif op[0] == "next":
            mgr.next_check_round()
        elif op[0] == "fault":
            out.append(mgr.check_fault_node())
        elif op[0] == "stragglers":
            out.append(mgr.get_stragglers(ratio=op[1]))
        else:
            mgr._check_round = op[2]
            out.append(mgr._group_nodes(op[1]))
    return out


@pytest.mark.parametrize("name", sorted(NET_SCRIPTS))
def test_the_network_check_rendezvous_is_the_jax_managers(name):
    mine = _run_net(TNet(), NET_SCRIPTS[name])
    assert mine == _run_net(JNet(), NET_SCRIPTS[name])
    if name == "fault_in_both_rounds":
        assert mine[-1] == ([2], 1)
    if name == "stragglers":
        assert mine[-3] == ([3], 0) and mine[-2] == ([], 0)
    if name == "rounds_through_the_rendezvous":
        assert mine[-2] == ([2], 2) and mine[-1] == ([3], 2)
        # round 1 pairs (0, 1) and (2, 3); round 2 (0, 3) and (1, 2)
        assert [w[2] for w in mine[4:7]] == [{0: 1, 1: 1}, {2: 1, 3: 1},
                                             {2: 1, 3: 1}]
        assert [w[2] for w in mine[16:19]] == [{0: 1, 3: 1}, {1: 1, 2: 1},
                                               {0: 1, 3: 1}]


def _servicer_replies(servicer, deserialize, serialize):
    replies = []
    for rank, ok, secs in ((0, True, 1.0), (1, False, 0.0), (2, True, 9.0),
                           (3, True, 1.0)):
        raw = jmsgs.serialize(jmsgs.NetworkCheckResult(
            node_id=rank, elapsed_time=secs, succeeded=ok))
        replies.append(servicer.report(deserialize(raw)))
    for rank in (0, 1, 2):
        raw = jmsgs.serialize(jmsgs.NetworkCheckStatusRequest(node_id=rank))
        replies.append(serialize(servicer.get(deserialize(raw))))
    return replies


def test_the_servicer_answers_the_network_check_as_jax():
    """A JAX-encoded result and status request, to a servicer with each
    package's network-check manager: the same replies, byte for byte
    (node 1 faulty, node 2 a straggler)."""
    theirs = JServicer(rdzv_managers={RendezvousName.NETWORK_CHECK: JNet()})
    mine = MasterServicer(rdzv_managers={RendezvousName.NETWORK_CHECK:
                                         TNet()})
    assert _servicer_replies(mine, msgs.deserialize, msgs.serialize) == \
        _servicer_replies(theirs, jmsgs.deserialize, jmsgs.serialize)
    resp = mine.get(msgs.NetworkCheckStatusRequest(node_id=1))
    assert (resp.normal, resp.fault_nodes, resp.stragglers) == (
        False, [1], [2])
    assert MasterServicer.unported("NetworkCheckResult") is None


# ---- the launcher's network check ------------------------------------------


def _nodes_check(monkeypatch, results, exclude_straggler):
    """Nodes 0..n-1 of one in-process master run the launcher's network
    check at once, each node's check giving ``results[node]``; their
    return codes and what the master recorded."""
    n = len(results)
    monkeypatch.setenv("DLROVER_TPU_CTX_RDZV_WAIT_EXTRA_NODES_S", "0")
    master = JobMaster(port=0, num_workers=n)
    master.prepare()
    mine = threading.local()
    monkeypatch.setattr(launcher, "run_node_check",
                        lambda: results[mine.node])
    monkeypatch.setattr(launcher.time, "sleep", lambda s: None)
    rcs = {}

    def node(i):
        mine.node = i
        client = MasterClient(master.addr, node_id=i)
        client.register_node(local_chips=1)
        config = ElasticLaunchConfig(node_id=i, min_nodes=n, max_nodes=n,
                                     exclude_straggler=exclude_straggler,
                                     rdzv_timeout_s=30)
        rcs[i] = launcher._run_network_check(client, config)

    try:
        threads = [threading.Thread(target=node, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        statuses = {i: master.job_manager.get_node(i).status
                    for i in range(n)}
    finally:
        master.stop()
    return rcs, statuses


def test_a_faulty_node_exits_3_and_the_healthy_ones_go_on(monkeypatch):
    rcs, statuses = _nodes_check(
        monkeypatch, [(True, 1.0), (True, 1.0), (False, 0.0), (True, 1.1)],
        exclude_straggler=False)
    assert rcs == {0: 0, 1: 0, 2: 3, 3: 0}
    assert statuses[2] == "check_failed"
    assert statuses[0] == "running"


@pytest.mark.parametrize("exclude", [True, False])
def test_a_straggler_exits_3_only_under_exclude_straggler(monkeypatch,
                                                          exclude):
    rcs, statuses = _nodes_check(
        monkeypatch, [(True, 1.0), (True, 1.0), (True, 5.0), (True, 1.0)],
        exclude_straggler=exclude)
    assert rcs == {0: 0, 1: 0, 2: 3 if exclude else 0, 3: 0}
    assert statuses[2] == ("check_failed" if exclude else "running")


def test_the_launcher_flags_reach_its_config():
    args = launcher.parse_args(["--network-check", "--comm-perf-test",
                                "--exclude-straggler", "--", "x"])
    assert (args.network_check, args.comm_perf_test,
            args.exclude_straggler, args.entrypoint) == (True, True, True,
                                                         ["x"])
    args = launcher.parse_args(["--", "x"])
    assert not (args.network_check or args.comm_perf_test
                or args.exclude_straggler)


def test_the_launcher_on_a_node_without_a_gpu_exits_3(tmp_path):
    """``--network-check`` runs on the node's GPUs: without one the check
    fails both rounds, the local master finds the node faulty, and the
    launcher exits 3 before it starts a worker."""
    marker = tmp_path / "worker_ran"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               DLROVER_TPU_RUN_ID=f"nc{os.getpid()}",
               DLROVER_TPU_COORDINATOR_PORT="0", TMPDIR=str(tmp_path))
    env.pop("DLROVER_TPU_MASTER_ADDR", None)
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.agent.launcher",
         "--nnodes", "1", "--nproc", "1", "--network-check", "--",
         sys.executable, "-c", f"open({str(marker)!r}, 'w')"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert "node check failed" in proc.stderr
    assert "normal=False faults=[0]" in proc.stderr
    assert not marker.exists()
