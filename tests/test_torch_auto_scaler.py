"""The port's auto-scaling loop (``master/auto_scaler.py``,
``master/resource_optimizer.py``, ``JobManager.set_worker_num``) against
the JAX package's, on the CPU.

- ``LocalHeuristicOptimizer``: the same (workers, speed, pending)
  series gives the same plans;
- ``JobAutoScaler`` over it: the same speed series and node
  registrations, tick by tick, give the same targets, the same
  ``ScalePlan`` worker counts, the same rendezvous bounds and the same
  released nodes, with and without the grace window; a plan past the
  job's range is clamped to it;
- the sparse-tier hints of a Brain plan reach ``ElasticPsService`` (the
  weights, one version bump, idempotent) and the platform's PS hook
  (``tests/test_master.py``'s case);
- the speed reaches the Brain: the port hands it as ``steps_per_sec``
  too, so a ``BrainService`` plans a running job's growth (the JAX loop
  sends only ``speed``, which the Brain does not read: no plan).
"""

import pytest

from dlrover_tpu.common.messages import NodeMeta as JMeta
from dlrover_tpu.master import auto_scaler as jas
from dlrover_tpu.master import node_manager as jnm
from dlrover_tpu.master import rdzv_manager as jrdzv
from dlrover_tpu.master import resource_optimizer as jro
from dlrover_tpu_torch.common.messages import NodeMeta
from dlrover_tpu_torch.master import auto_scaler as tas
from dlrover_tpu_torch.master import node_manager as tnm
from dlrover_tpu_torch.master import rdzv_manager as trdzv
from dlrover_tpu_torch.master import resource_optimizer as tro

PKGS = ((tas, tnm, trdzv, tro, NodeMeta), (jas, jnm, jrdzv, jro, JMeta))


class FakeSpeed:
    running_speed = 0.0


SERIES = [
    # (workers, steps/s, pending)
    (1, 1.0, 0), (2, 1.9, 0), (3, 2.1, 0), (3, 2.2, 0), (4, 0.0, 0),
    (4, 3.0, 2), (2, 1.8, 0), (2, 2.0, 0), (1, 0.9, 1), (3, 2.9, 0),
]


@pytest.mark.parametrize("floor", [0.7, 0.95])
@pytest.mark.parametrize("unit,lo,hi", [(1, 1, 4), (2, 2, 8), (1, 2, 2)])
def test_the_local_heuristic_plans_as_jax(floor, unit, lo, hi):
    plans = []
    for _, _, _, ro, _ in PKGS:
        opt = ro.LocalHeuristicOptimizer(min_workers=lo, max_workers=hi,
                                         node_unit=unit,
                                         efficiency_floor=floor)
        plans.append([
            (p.worker_num, p.node_resources, p.empty())
            for p in (opt.generate_plan("running", {
                "worker_num": w, "speed": s, "pending_nodes": n})
                for w, s, n in SERIES)])
    assert plans[0] == plans[1]


# speeds a tick, and the nodes registered by then
TICKS = [(0.0, 1), (1.0, 1), (1.0, 1), (1.8, 2), (1.8, 2), (2.5, 3),
         (2.6, 3), (2.6, 3), (2.7, 4), (2.7, 4), (2.8, 4)]


def _drive(pkg, grace_s, lo=1, hi=4, unit=1, ticks=TICKS):
    auto_scaler, nm, rdzv, _, meta = pkg
    jm = nm.JobManager(num_workers=lo)
    scaler = nm.NoopScaler()
    mgr = rdzv.ElasticTrainingRendezvousManager()
    mgr.update_rdzv_params(min_nodes=lo, max_nodes=hi, waiting_timeout=30.0,
                           node_unit=unit)
    speed = FakeSpeed()
    a = auto_scaler.JobAutoScaler(jm, speed, scaler,
                                  rdzv_managers={"t": mgr}, min_workers=lo,
                                  max_workers=hi, node_unit=unit)
    a.pending_grace_s = grace_s
    trail = []
    for s, nodes in ticks:
        speed.running_speed = s
        for i in range(nodes):
            if jm.get_node(i) is None or jm.get_node(i).status != "running":
                jm.register_node(meta(node_id=i, node_rank=i))
        a.adjust_once()
        trail.append((jm.worker_num, [p.worker_num for p in scaler.plans],
                      mgr._min_nodes, mgr._max_nodes,
                      sorted(i for i in range(8) if jm.get_node(i)
                             and jm.get_node(i).is_released)))
    return trail


@pytest.mark.parametrize("grace_s", [900.0, 0.0])
@pytest.mark.parametrize("lo,hi,unit", [(1, 4, 1), (1, 2, 1), (2, 6, 2)])
def test_the_auto_scaler_scales_as_jax(grace_s, lo, hi, unit):
    mine = _drive(PKGS[0], grace_s, lo, hi, unit)
    theirs = _drive(PKGS[1], grace_s, lo, hi, unit)
    assert mine == theirs
    if grace_s:
        assert mine[-1][0] > lo  # it grew


def test_unplaceable_nodes_scale_in_and_are_released():
    """Past the grace window, a node the platform never placed makes the
    heuristic fall back to a smaller world: the highest-indexed node is
    released (its exit is not a failure), and the size that did not
    speed up is not grown into again."""
    ticks = [(1.0, 1), (2.0, 1), (2.0, 1), (2.0, 1)]
    mine = _drive(PKGS[0], 0.0, 1, 4, 1, ticks)
    assert mine == _drive(PKGS[1], 0.0, 1, 4, 1, ticks)
    assert [t[0] for t in mine] == [2, 1, 1, 1]
    assert mine[1][4] == [1]


class _FixedPlan:
    def __init__(self, ro, n):
        self.plan = ro.ResourcePlan(worker_num=n)

    def generate_plan(self, stage, stats):
        return self.plan


@pytest.mark.parametrize("target", [0, 1, 3, 9])
def test_a_plan_is_clamped_to_the_jobs_range(target):
    out = []
    for pkg in PKGS:
        auto_scaler, nm, rdzv, ro, _ = pkg
        jm = nm.JobManager(num_workers=2)
        scaler = nm.NoopScaler()
        a = auto_scaler.JobAutoScaler(jm, FakeSpeed(), scaler,
                                      optimizer=_FixedPlan(ro, target),
                                      min_workers=2, max_workers=4)
        a.pending_grace_s = 0.0
        a.execute_plan(a.optimizer.plan)
        out.append((jm.worker_num, [p.worker_num for p in scaler.plans]))
    assert out[0] == out[1] == (min(4, max(2, target)),
                                [min(4, max(2, target))])


def test_the_brains_ps_weights_reach_the_sparse_tier():
    from dlrover_tpu_torch.master.master import JobMaster

    master = JobMaster(port=0, num_workers=1)
    try:
        scaler = tas.JobAutoScaler(master.job_manager, master.speed_monitor,
                                   tnm.NoopScaler(),
                                   ps_service=master.ps_service)
        v0 = master.ps_service.get_global_version()
        plan = tro.ResourcePlan()
        plan.node_resources["ps"] = {"weights": {"ps0": 0.5, "ps1": 1.0}}
        scaler.execute_plan(plan)
        assert master.ps_service.get_weights() == {"ps0": 0.5, "ps1": 1.0}
        assert master.ps_service.get_global_version() == v0 + 1
        scaler.execute_plan(plan)  # the same weights: no version churn
        assert master.ps_service.get_global_version() == v0 + 1
        targets = []
        scaler.ps_scale_fn = targets.append
        plan2 = tro.ResourcePlan()
        plan2.node_resources["ps"] = {"num": 3}
        scaler.execute_plan(plan2)
        assert targets == [3]
        scaler.ps_scale_fn = None
        scaler.execute_plan(plan2)  # no hook bound: logged, not raised
        assert master.job_manager.worker_num == 1
    finally:
        master.stop()


def test_the_speed_reaches_the_brains_running_algorithm():
    from dlrover_tpu.cluster.brain import BrainService as JBrain
    from dlrover_tpu_torch.cluster.brain import BrainService

    out = []
    for pkg, svc in ((PKGS[0], BrainService()), (PKGS[1], JBrain())):
        svc.bind_job("j", "k")
        out.append(_drive(pkg, 900.0, 1, 2, 1, [(1.0, 1), (1.0, 1)]))
        # the same auto-scaler again, over the Brain
        auto_scaler, nm, _, _, meta = pkg
        jm = nm.JobManager(num_workers=1)
        jm.register_node(meta(node_id=0, node_rank=0))
        scaler = nm.NoopScaler()
        speed = FakeSpeed()
        speed.running_speed = 1.5
        auto_scaler.JobAutoScaler(jm, speed, scaler, optimizer=svc,
                                  min_workers=1, max_workers=2).adjust_once()
        out.append([p.worker_num for p in scaler.plans])
    assert out[0] == out[2]            # the heuristic: the same
    assert out[1] == [2]               # the port's loop feeds the Brain
    assert out[3] == []                # the JAX one's Brain sees no speed
