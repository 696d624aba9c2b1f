"""The port's rendezvous manager and job manager against the JAX
package's, on the CPU.

- the same scripted sequences (joins, a late joiner, ``node_unit``,
  ``max_nodes``, a node leaving the sealed world, a member re-joining)
  go through the JAX ``ElasticTrainingRendezvousManager`` and the
  port's, and every step gives the same round, sealed world,
  coordinator (the JAX package's port 7010 when the joining node sends
  none) and waiting count;
- the port's manager hands out the first node's store port when its
  agent sends one;
- the live-reshard directive: with one process a node the port's
  manager excises the same nodes as the JAX one; with several ranks a
  node, a node leaves the sealed world only when all of its dp ranks
  are lost, and a lost node's death does not end the survivors' round;
- ``JobManager``: the same registrations, status reports and heartbeat
  timeouts give the same node statuses, exit reasons, relaunch counts,
  incarnations and relaunch plans.
"""

import time

import pytest

from dlrover_tpu.common import messages as jmsgs
from dlrover_tpu.master import node_manager as jnm
from dlrover_tpu.master.rdzv_manager import (
    ElasticTrainingRendezvousManager as JRdzv,
)
from dlrover_tpu_torch.common import messages as msgs
from dlrover_tpu_torch.master import node_manager as tnm
from dlrover_tpu_torch.master.rdzv_manager import (
    ElasticTrainingRendezvousManager as TRdzv,
)

# (params, script): an op is ("join", node_id, rank, local_world_size,
# host), ("world", rank), ("waiting",) or ("leave", rank)
SCRIPTS = {
    "two_nodes": (dict(min_nodes=2, max_nodes=2, waiting_timeout=3600), [
        ("join", 0, 0, 4, "h0"), ("world", 0), ("waiting",),
        ("join", 1, 1, 4, "h1"), ("world", 0), ("world", 1), ("waiting",),
    ]),
    "late_joiner": (dict(min_nodes=1, max_nodes=2, waiting_timeout=0), [
        ("join", 0, 0, 2, "h0"), ("world", 0), ("join", 1, 1, 2, "h1"),
        ("waiting",), ("world", 1),
        # the sealed member re-joins (it restarted to take the joiner in)
        ("join", 0, 0, 2, "h0"), ("world", 0), ("world", 1), ("waiting",),
    ]),
    "node_unit": (dict(min_nodes=2, max_nodes=4, waiting_timeout=0,
                       node_unit=2), [
        ("join", 0, 0, 1, "a"), ("join", 1, 1, 1, "b"),
        ("join", 2, 2, 1, "c"), ("world", 0), ("waiting",), ("world", 2),
    ]),
    "max_nodes": (dict(min_nodes=1, max_nodes=2, waiting_timeout=3600), [
        ("join", 5, 3, 8, "x"), ("join", 6, 1, 8, "y"),
        ("join", 7, 2, 8, "z"), ("world", 1), ("waiting",), ("world", 2),
    ]),
    "leave": (dict(min_nodes=2, max_nodes=2, waiting_timeout=3600), [
        ("join", 0, 0, 1, ""), ("join", 1, 1, 1, ""), ("world", 0),
        ("leave", 1), ("world", 0), ("join", 0, 0, 1, ""), ("waiting",),
        ("join", 1, 1, 1, ""), ("world", 1),
    ]),
}


def _run(mgr, params, script):
    mgr.update_rdzv_params(**params)
    out = []
    for op in script:
        if op[0] == "join":
            _, node_id, rank, lws, host = op
            out.append(("join", mgr.join_rendezvous(node_id, rank, lws,
                                                    host_addr=host)))
        elif op[0] == "world":
            out.append(("world", mgr.get_comm_world(op[1])))
        elif op[0] == "waiting":
            out.append(("waiting", mgr.num_nodes_waiting()))
        else:
            mgr.remove_alive_node(op[1])
            out.append(("leave", mgr.rdzv_round))
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_rendezvous_decisions_equal_the_jax_managers(name):
    params, script = SCRIPTS[name]
    theirs = _run(JRdzv(), params, script)
    mine = _run(TRdzv(), params, script)
    assert mine == theirs
    assert any(op == "world" and w[2] for op, w in mine)  # a world sealed


def test_the_first_nodes_store_port_is_the_coordinators():
    mgr = TRdzv()
    mgr.update_rdzv_params(min_nodes=2, max_nodes=2)
    mgr.join_rendezvous(1, 1, 1, host_addr="b", coordinator_port=2222)
    mgr.join_rendezvous(0, 0, 1, host_addr="a", coordinator_port=1111)
    assert mgr.get_comm_world(0)[3] == "a:1111"
    # a node that sends none gets the JAX package's port
    mgr = TRdzv()
    mgr.join_rendezvous(0, 0, 1, host_addr="a")
    assert mgr.get_comm_world(0)[3] == "a:7010"


def _sealed(mgr, lws):
    """A sealed world of ``len(lws)`` nodes, node ``i`` with ``lws[i]``
    ranks."""
    mgr.update_rdzv_params(min_nodes=len(lws), max_nodes=len(lws))
    for i, n in enumerate(lws):
        mgr.join_rendezvous(i, i, n)
    return mgr.get_comm_world(0)[2]


def test_one_process_nodes_reshard_as_the_jax_manager_does():
    worlds = []
    for mgr in (JRdzv(), TRdzv()):
        _sealed(mgr, [1, 1, 1, 1])
        mgr.plan_reshard([2, 3], dp_size=4)
        before = mgr.get_comm_world(0)[:3]
        mgr.remove_alive_node(3)  # a lost node dies: no new round
        worlds.append((before, mgr.get_comm_world(0)[:3],
                       mgr.get_reshard_plan()["lost_ranks"]))
    assert worlds[1] == worlds[0]
    assert worlds[1][1][2] == {0: 1, 1: 1}


# (local world sizes, evictions as (lost dp ranks, dp size), the nodes
# lost by each, the sealed world after them)
RESHARDS = {
    "one_node_dp0_dp1": ([4], [([0, 1], 4)], [[]], {0: 4}),
    "one_node_dp2_dp3": ([4], [([2, 3], 4)], [[]], {0: 4}),
    "second_node_whole": ([2, 2], [([2, 3], 4)], [[1]], {0: 2}),
    "first_node_whole": ([2, 2], [([0, 1], 4)], [[0]], {1: 2}),
    "a_rank_of_each": ([2, 2], [([1, 2], 4)], [[]], {0: 2, 1: 2}),
    # dp 1 of the survivors [0, 3] is node 1's last rank
    "two_evictions": ([2, 2], [([1, 2], 4), ([1], 2)], [[], [1]],
                      {0: 2}),
}


@pytest.mark.parametrize("name", sorted(RESHARDS))
def test_a_node_leaves_only_when_all_its_dp_ranks_are_lost(name):
    lws, evictions, lost_nodes, world = RESHARDS[name]
    mgr = TRdzv()
    _sealed(mgr, lws)
    rdzv_round = mgr.rdzv_round
    for (lost, dp), nodes in zip(evictions, lost_nodes):
        mgr.plan_reshard(lost, dp_size=dp)
        plan = mgr.get_reshard_plan()
        assert (plan["lost_ranks"], plan["lost_nodes"]) == (lost, nodes)
    assert mgr.get_comm_world(0)[2] == world
    for node in lost_nodes[-1]:
        mgr.remove_alive_node(node)  # its processes end: the round stays
    assert mgr.get_comm_world(0)[:3] == (rdzv_round, 0, world)
    # a surviving node's death still ends the round
    mgr.remove_alive_node(min(world))
    assert mgr.get_comm_world(0)[2] == {}


def _meta(pkg, node_id):
    return pkg.NodeMeta(node_id=node_id, node_rank=node_id,
                        host_addr=f"h{node_id}", local_chips=4)


def _snapshot(jm):
    nodes = {}
    for i in sorted(jm._nodes):
        n = jm.get_node(i)
        nodes[i] = (n.status, n.exit_reason, n.relaunch_count,
                    n.incarnation, n.rank_index)
    plans = [[n.name for n in p.launch_nodes] for p in jm._scaler.plans]
    return nodes, plans


def _drive(nm, pkg, events):
    jm = nm.JobManager(num_workers=3, relaunch_budget=1)
    for i in range(3):
        jm.register_node(_meta(pkg, i))
    out = [_snapshot(jm)]
    for node_id, status, reason in events:
        jm.handle_status_report(node_id, status, reason)
        out.append(_snapshot(jm))
    return out


def test_status_reports_give_the_jax_transitions():
    events = [(0, "failed", ""), (0, "running", ""), (0, "failed", ""),
              (1, "succeeded", ""), (1, "failed", ""), (2, "failed",
                                                        "killed"),
              (2, "deleted", ""), (0, "deleted", "fatal_error")]
    assert _drive(tnm, msgs, events) == _drive(jnm, jmsgs, events)


def test_heartbeat_timeouts_give_the_jax_transitions():
    managers = []
    for nm, pkg in ((jnm, jmsgs), (tnm, msgs)):
        jm = nm.JobManager(num_workers=2, relaunch_budget=2,
                           heartbeat_timeout_s=1.0)
        for i in range(2):
            jm.register_node(_meta(pkg, i))
        managers.append(jm)
    for jm in managers:
        jm.start()
    try:
        # node 0 keeps beating, node 1 goes silent
        deadline = time.time() + 2.8
        while time.time() < deadline:
            for jm in managers:
                jm.handle_heartbeat(0)
            time.sleep(0.05)
    finally:
        for jm in managers:
            jm.stop()
    theirs, mine = (_snapshot(jm) for jm in managers)
    assert mine == theirs
    # node 1 was relaunched (a heartbeat timeout costs no budget: killed)
    assert mine[0][1][0] == "initial" and mine[0][1][3] == 1
    assert mine[0][0][0] == "running" and mine[1] == [["worker-1"]]
