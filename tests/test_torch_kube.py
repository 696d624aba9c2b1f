"""The port's cluster binding against the JAX package's, on the CPU: the
CRDs (``cluster/crd.py``), the slice scaler (``cluster/scaler.py``), the
API double, pod watcher and reconciler (``cluster/kube.py``).

Each scenario is one of the JAX package's own cases
(``tests/test_kube.py``, and the scaler and CRD cases of
``tests/test_cluster.py``) written once over a package namespace
(``torch_cluster_util.packages``) and run on each package's own
``FakeKubeApi``: the two give the same pod names, labels and env (but
for the GPU keys and the node id, ``normal_pod``), creation order,
``NodeEvent``s, node states and ScalePlan phases, and the JAX case's own
assertions hold on both.

Three differences are the port's repairs, each pinned here with the JAX
package's behaviour beside it:
- every pod carries ``DLROVER_TPU_NODE_ID`` = its host index, which the
  launcher reads (the JAX manifest sets ``DLROVER_TPU_NODE_RANK`` only,
  so every pod of a JAX job is node 0);
- a status write on the ElasticJob does not re-apply the spec's replica
  count (the JAX reconciler's does, deleting the pod a ScalePlan grew);
- the node selector and device resource name a GPU node.
"""

import json
import threading
import time

import pytest

from torch_cluster_util import (
    added_pods,
    demo_job,
    normal_pod,
    packages,
    wait,
)

PKGS = packages()


def _both(scenario, *args):
    """The scenario's trace from each package: (JAX's, the port's)."""
    return tuple(scenario(PKGS[name], *args) for name in ("jax", "torch"))


def _pods(api, selector=None):
    sel = {"elasticjob.dlrover/name": "demo"} if selector is None else selector
    return [normal_pod(p) for p in api.list("Pod", label_selector=sel)]


def _node_state(jm, ids):
    return {i: (jm.get_node(i).status, jm.get_node(i).relaunch_count,
                jm.get_node(i).incarnation) for i in ids}


def _direct(pkg, api, replicas, budget, max_hosts=4, master_addr=""):
    """The master-direct wiring of the JAX tests: a slice scaler over
    the store, a job manager relaunching through it, a pod watcher."""
    job = demo_job(pkg, replicas=replicas, max_hosts=max_hosts)
    scaler = pkg.scaler.SliceScaler(
        job, submit_fn=api.create,
        delete_fn=lambda name: api.delete("Pod", name),
        master_addr=master_addr)
    jm = pkg.nm.JobManager(num_workers=replicas, relaunch_budget=budget,
                           scaler=scaler)
    watcher = pkg.kube.PodWatcher(api, "demo", jm.process_event)
    plan = pkg.nm.ScalePlan()
    plan.worker_num = replicas
    scaler.scale(plan)
    return scaler, jm, watcher


# ---- the API double ------------------------------------------------------


def _store_and_replay(pkg):
    api = pkg.kube.FakeKubeApi()
    label = {pkg.kube.JOB_LABEL: "demo"}
    api.create({"kind": "Pod", "metadata": {"name": "p0", "labels": label}})
    api.create({"kind": "Pod", "metadata": {"name": "p1"}})
    counts = (len(api.list("Pod")), len(api.list("Pod",
                                                 label_selector=label)))
    api.set_pod_phase("p0", "Running")
    api.delete("Pod", "p1")
    stop = threading.Event()
    seen = []
    for ev in api.watch(kind="Pod", since_rv=0, stop=stop, poll_s=0.01):
        seen.append((ev.type, ev.name, ev.resource_version))
        if len(seen) == 4:
            stop.set()
    stop2 = threading.Event()
    tail = []
    for ev in api.watch(kind="Pod", since_rv=2, stop=stop2, poll_s=0.01):
        tail.append(ev.type)
        if len(tail) == 2:
            stop2.set()
    return {"counts": counts, "seen": seen, "tail": tail,
            "latest": api.latest_rv(), "list_rv": api.list_rv("Pod")}


def test_the_api_double_stores_and_replays_as_jax():
    jax, port = _both(_store_and_replay)
    assert port == jax
    assert [s[:2] for s in port["seen"]] == [
        ("ADDED", "p0"), ("ADDED", "p1"), ("MODIFIED", "p0"),
        ("DELETED", "p1")]
    assert port["tail"] == ["MODIFIED", "DELETED"]


def _status_semantics(pkg):
    """A main-resource update keeps a CRD's stored status (the status
    subresource), a Pod's status is written; duplicate creates and
    unknown updates raise."""
    api = pkg.kube.FakeKubeApi()
    api.create({"kind": "ElasticJob", "metadata": {"name": "j"},
                "spec": {"minHosts": 1}})
    api.update_status("ElasticJob", "j", {"phase": "Running"})
    obj = api.get("ElasticJob", "j")
    obj["status"] = {"phase": "Hacked"}
    obj["spec"]["minHosts"] = 2
    api.update(obj)
    out = api.get("ElasticJob", "j")
    errors = []
    for call in (lambda: api.create({"kind": "ElasticJob",
                                     "metadata": {"name": "j"}}),
                 lambda: api.update({"kind": "Pod",
                                     "metadata": {"name": "x"}}),
                 lambda: api.create({"kind": "Pod", "metadata": {}})):
        try:
            call()
        except (KeyError, ValueError) as e:
            errors.append(type(e).__name__)
    return {"status": out["status"], "spec": out["spec"], "errors": errors,
            "missing": api.update_status("ElasticJob", "nope", {}),
            "events": [(e.type, e.kind, e.name) for e in api._events]}


def test_the_status_subresource_semantics_are_the_jax_doubles():
    jax, port = _both(_status_semantics)
    assert port == jax
    assert port["status"] == {"phase": "Running"}
    assert port["spec"] == {"minHosts": 2}


# ---- pod events -----------------------------------------------------------

_POD_CASES = [
    ("MODIFIED", "Running", ""), ("MODIFIED", "Pending", ""),
    ("MODIFIED", "Succeeded", ""), ("MODIFIED", "Failed", "OOMKilled"),
    ("MODIFIED", "Failed", "Evicted"), ("MODIFIED", "Failed", "Preempted"),
    ("MODIFIED", "Failed", "DeadlineExceeded"),
    ("MODIFIED", "Failed", "FatalError"), ("MODIFIED", "Failed", "Error"),
    ("MODIFIED", "Unknown", ""), ("MODIFIED", "Weird", ""),
    ("DELETED", "Running", ""), ("DELETED", "Failed", "OOMKilled"),
]


@pytest.mark.parametrize("etype,phase,reason", _POD_CASES)
def test_a_pod_event_becomes_the_jax_node_event(etype, phase, reason):
    out = []
    for name in ("jax", "torch"):
        kube = PKGS[name].kube
        ev = kube.WatchEvent(etype, {
            "kind": "Pod",
            "metadata": {"name": "x", "labels": {
                kube.JOB_LABEL: "demo", kube.RANK_LABEL: "3",
                kube.INCARNATION_LABEL: "2"}},
            "status": {"phase": phase, "reason": reason}})
        ne = kube.pod_to_node_event(ev)
        out.append(None if ne is None else (
            ne.event_type, ne.node_id, ne.status, ne.exit_reason,
            ne.incarnation))
    assert out[1] == out[0]
    if (etype, phase, reason) == ("MODIFIED", "Failed", "OOMKilled"):
        assert out[1][1:4] == (3, "failed", "oom")


def test_unlabelled_or_foreign_events_are_not_node_events():
    for name in ("jax", "torch"):
        kube = PKGS[name].kube
        assert kube.pod_to_node_event(kube.WatchEvent(
            "MODIFIED", {"kind": "Pod", "metadata": {}})) is None
        assert kube.pod_to_node_event(kube.WatchEvent(
            "MODIFIED", {"kind": "Service", "metadata": {
                "labels": {kube.RANK_LABEL: "0"}}})) is None


# ---- the master-direct loop ----------------------------------------------


def _relaunch_on_oom(pkg):
    api = pkg.kube.FakeKubeApi()
    _, jm, watcher = _direct(pkg, api, 2, 2, master_addr="10.0.0.1:8000")
    first = _pods(api)
    watcher.start()
    api.set_pod_phase("demo-worker-0", "Running")
    api.set_pod_phase("demo-worker-1", "Running")
    running = pkg.const.NodeStatus.RUNNING
    wait(lambda: all(jm.get_node(i).status == running for i in (0, 1)))
    api.set_pod_phase("demo-worker-0", "Failed", reason="OOMKilled")
    wait(lambda: api.get("Pod", "demo-worker-0-r1") is not None)
    api.set_pod_phase("demo-worker-0-r1", "Running")
    wait(lambda: jm.get_node(0).status == running)
    time.sleep(0.3)  # a stale DELETED of the predecessor must not count
    out = {"first": first, "added": added_pods(api), "pods": _pods(api),
           "nodes": _node_state(jm, (0, 1)),
           "r2": api.get("Pod", "demo-worker-0-r2")}
    watcher.stop()
    jm.stop()
    return out


def test_the_reconcile_loop_relaunches_as_jax():
    jax, port = _both(_relaunch_on_oom)
    assert port == jax
    assert port["added"] == ["demo-worker-0", "demo-worker-1",
                             "demo-worker-0-r1"]
    assert port["nodes"][0] == ("running", 1, 1)
    assert port["r2"] is None
    labels = [p["metadata"]["labels"] for p in port["pods"]
              if p["metadata"]["name"] == "demo-worker-0-r1"][0]
    assert labels["elasticjob.dlrover/rank-index"] == "0"


def _budget(pkg, reason):
    api = pkg.kube.FakeKubeApi()
    _, jm, watcher = _direct(pkg, api, 1, 1)
    watcher.start()
    running = pkg.const.NodeStatus.RUNNING
    for attempt, name in ((1, "demo-worker-0"), (2, "demo-worker-0-r1")):
        api.set_pod_phase(name, "Running")
        wait(lambda: jm.get_node(0).status == running)
        api.set_pod_phase(name, "Failed", reason=reason)
        if reason == "Evicted" or attempt == 1:
            wait(lambda: api.get("Pod", f"demo-worker-0-r{attempt}")
                 is not None)
    time.sleep(0.3)
    node = jm.get_node(0)
    out = {"added": added_pods(api), "nodes": _node_state(jm, (0,)),
           "fatal": node.is_exited() and node.status == "failed"
           and not node.should_relaunch()}
    watcher.stop()
    jm.stop()
    return out


def test_an_exhausted_budget_stops_the_churn_as_jax():
    jax, port = _both(_budget, "Error")
    assert port == jax
    assert port["added"] == ["demo-worker-0", "demo-worker-0-r1"]
    assert port["fatal"]


def test_an_eviction_relaunch_gets_a_unique_name_as_jax():
    jax, port = _both(_budget, "Evicted")
    assert port == jax
    assert port["added"][-1] == "demo-worker-0-r2"
    assert port["nodes"][0][1:] == (0, 2)  # no budget spent, incarnation 2


def _scale_in(pkg, fail):
    api = pkg.kube.FakeKubeApi()
    n = 4 if fail else 3
    scaler, jm, watcher = _direct(pkg, api, n, 2)
    watcher.start()
    for i in range(n):
        api.set_pod_phase(f"demo-worker-{i}", "Running")
    running = pkg.const.NodeStatus.RUNNING
    wait(lambda: all(jm.get_node(i).status == running for i in range(n)))
    target = 2 if fail else 1
    jm.set_worker_num(target)
    plan = pkg.nm.ScalePlan()
    plan.worker_num = target
    scaler.scale(plan)
    if fail:
        api.set_pod_phase("demo-worker-0", "Failed", reason="Error")
        api.set_pod_phase("demo-worker-1", "Failed", reason="OOMKilled")
        wait(lambda: api.get("Pod", "demo-worker-1-r1") is not None)
        api.set_pod_phase("demo-worker-0-r1", "Running")
        api.set_pod_phase("demo-worker-1-r1", "Running")
        wait(lambda: all(jm.get_node(i).status == running for i in (0, 1)))
    else:
        wait(lambda: len(api.list("Pod")) == 1)
    time.sleep(0.3)
    live = sorted(p["metadata"]["name"] for p in api.list("Pod")
                  if p.get("status", {}).get("phase") != "Failed")
    out = {"added": added_pods(api), "live": live,
           "nodes": _node_state(jm, range(target)),
           "hosts": scaler.live_hosts}
    watcher.stop()
    jm.stop()
    return out


def test_a_scale_in_does_not_resurrect_pods_as_jax():
    jax, port = _both(_scale_in, False)
    assert port == jax
    assert port["live"] == ["demo-worker-0"]


def test_failures_during_a_scale_in_relaunch_once_as_jax():
    jax, port = _both(_scale_in, True)
    assert port == jax
    assert port["live"] == ["demo-worker-0-r1", "demo-worker-1-r1"]
    assert [port["nodes"][i][1] for i in (0, 1)] == [1, 1]


def _watcher_resumes(pkg):
    api = pkg.kube.FakeKubeApi()
    job = demo_job(pkg)
    scaler = pkg.scaler.SliceScaler(job, submit_fn=api.create)
    plan = pkg.nm.ScalePlan()
    plan.worker_num = 2
    scaler.scale(plan)
    api.set_pod_phase("demo-worker-0", "Running")
    rv = api.latest_rv()
    events = []
    watcher = pkg.kube.PodWatcher(api, "demo", events.append)
    watcher.start(since_rv=rv)
    wait(lambda: len(events) >= 2)
    n_list = len(events)
    api.set_pod_phase("demo-worker-1", "Running")
    wait(lambda: len(events) > n_list)
    watcher.stop()
    return [(e.event_type, e.node_id, e.status, e.exit_reason,
             e.incarnation) for e in events]


def test_the_pod_watcher_lists_then_resumes_as_jax():
    jax, port = _both(_watcher_resumes)
    assert port == jax
    assert sorted(e[1] for e in port[:2]) == [0, 1]
    assert port[2:] == [("modified", 1, "running", "", 0)]


# ---- the reconciler (the operator's per-job loop) ------------------------


def _plays_operator(pkg):
    api = pkg.kube.FakeKubeApi()
    job = demo_job(pkg, replicas=2, max_hosts=6)
    rec = pkg.kube.JobReconciler(api, job)
    rec.start()
    api.create(job.to_manifest())
    wait(lambda: len(api.list("Pod")) == 2)
    api.create(pkg.crd.ScalePlanCRD(
        job_name="demo", name="sp-1",
        replica_counts={"worker": 4}).to_manifest())
    wait(lambda: len(api.list("Pod")) == 4)
    api.create(pkg.crd.ScalePlanCRD(
        job_name="demo", name="sp-2",
        remove_pods=["demo-worker-3"]).to_manifest())
    wait(lambda: api.get("Pod", "demo-worker-3") is None)
    wait(lambda: all((api.get("ScalePlan", n) or {}).get("status")
                     for n in ("sp-1", "sp-2")))
    out = {"added": added_pods(api), "pods": _pods(api),
           "plans": {n: api.get("ScalePlan", n)["status"]
                     for n in ("sp-1", "sp-2")}}
    rec.stop()
    return out


def test_the_reconciler_plays_the_operator_as_jax():
    jax, port = _both(_plays_operator)
    assert port == jax
    assert port["added"] == [f"demo-worker-{i}" for i in range(4)]
    assert [p["metadata"]["name"] for p in port["pods"]] == [
        "demo-worker-0", "demo-worker-1", "demo-worker-2"]
    assert port["plans"] == {"sp-1": {"phase": "Succeeded"},
                             "sp-2": {"phase": "Succeeded"}}


def _replays_safe(pkg):
    api = pkg.kube.FakeKubeApi()
    job = demo_job(pkg, replicas=2, max_hosts=6)
    rec = pkg.kube.JobReconciler(api, job)
    rec.start()
    api.create(job.to_manifest())
    wait(lambda: len(api.list("Pod")) == 2)
    api.create(pkg.crd.ScalePlanCRD(
        job_name="demo", name="sp-old",
        replica_counts={"worker": 1}).to_manifest())
    wait(lambda: len(api.list("Pod")) == 1)
    wait(lambda: (api.get("ScalePlan", "sp-old") or {}).get(
        "status", {}).get("phase") == "Succeeded")
    ej = api.get("ElasticJob", "demo")
    ej["spec"]["replicaSpecs"]["worker"]["replicas"] = 3
    api.update(ej)
    wait(lambda: len(api.list("Pod")) == 3)
    rec._reconcile(pkg.kube.WatchEvent("MODIFIED",
                                       api.get("ScalePlan", "sp-old")))
    time.sleep(0.3)
    out = {"added": added_pods(api),
           "live": sorted(p["metadata"]["name"] for p in api.list("Pod"))}
    rec.stop()
    return out


def test_a_completed_plan_replays_as_a_no_op_as_jax():
    jax, port = _both(_replays_safe)
    assert port == jax
    assert len(port["live"]) == 3


def _snaps(pkg):
    api = pkg.kube.FakeKubeApi()
    job = demo_job(pkg, replicas=4, max_hosts=8, hosts_per_slice=4)
    rec = pkg.kube.JobReconciler(api, job)
    rec.start()
    api.create(pkg.crd.ScalePlanCRD(
        job_name="demo", name="sp-1",
        replica_counts={"worker": 5}).to_manifest())
    wait(lambda: len(api.list("Pod")) == 8)
    out = _pods(api)
    rec.stop()
    return out


def test_the_reconciler_snaps_to_whole_slices_as_jax():
    jax, port = _both(_snaps)
    assert port == jax
    assert [p["metadata"]["labels"]["elasticjob.dlrover/slice-index"]
            for p in port] == ["0"] * 4 + ["1"] * 4


def _other_jobs_and_suspend(pkg):
    """Plans and jobs of another owner are ignored; a suspended spec
    moves nothing; a removePods name without an index is skipped."""
    api = pkg.kube.FakeKubeApi()
    job = demo_job(pkg, replicas=1, max_hosts=4)
    rec = pkg.kube.JobReconciler(api, job)
    rec.start()
    api.create(job.to_manifest())
    wait(lambda: len(api.list("Pod")) == 1)
    api.create(pkg.crd.ScalePlanCRD(job_name="other", name="sp-x",
                                    replica_counts={"worker": 3})
               .to_manifest())
    other = demo_job(pkg, name="other", replicas=3).to_manifest()
    api.create(other)
    ej = api.get("ElasticJob", "demo")
    ej["spec"]["suspend"] = True
    ej["spec"]["replicaSpecs"]["worker"]["replicas"] = 3
    api.update(ej)
    api.create(pkg.crd.ScalePlanCRD(job_name="demo", name="sp-y",
                                    remove_pods=["demo-worker-0-r1"])
               .to_manifest())
    wait(lambda: (api.get("ScalePlan", "sp-y") or {}).get("status"))
    time.sleep(0.3)
    out = {"added": added_pods(api),
           "plans": {n: (api.get("ScalePlan", n) or {}).get("status")
                     for n in ("sp-x", "sp-y")}}
    rec.stop()
    return out


def test_foreign_plans_and_a_suspended_job_move_nothing_as_jax():
    jax, port = _both(_other_jobs_and_suspend)
    assert port == jax
    assert port["added"] == ["demo-worker-0"]
    assert port["plans"] == {"sp-x": None, "sp-y": {"phase": "Succeeded"}}


def _status_write_after_a_plan(pkg):
    """A ScalePlan grows the job to 2; then a status write on the
    ElasticJob (what the operator's status loop makes) reaches the
    reconciler as a MODIFIED event."""
    api = pkg.kube.FakeKubeApi()
    job = demo_job(pkg, replicas=1, max_hosts=2)
    rec = pkg.kube.JobReconciler(api, job)
    rec.start()
    api.create(job.to_manifest())
    wait(lambda: len(api.list("Pod")) == 1)
    api.create(pkg.crd.ScalePlanCRD(job_name="demo", name="sp-1",
                                    replica_counts={"worker": 2})
               .to_manifest())
    wait(lambda: len(api.list("Pod")) == 2)
    api.update_status("ElasticJob", "demo",
                      {"phase": "Running",
                       "replicaStatuses": {"worker": {"Running": 2}}})
    # the event as the reconciler's watch delivers it, here at once
    rec._reconcile(pkg.kube.WatchEvent("MODIFIED",
                                       api.get("ElasticJob", "demo")))
    time.sleep(0.3)
    out = sorted(p["metadata"]["name"] for p in api.list("Pod"))
    rec.stop()
    return out


def test_a_status_write_does_not_undo_a_scale_plan_in_the_port():
    """The repair: the JAX reconciler re-applies the spec's count at
    every ElasticJob event, so the status write deletes the pod the plan
    grew; the port's applies a spec only when it changed."""
    jax, port = _both(_status_write_after_a_plan)
    assert jax == ["demo-worker-0"]
    assert port == ["demo-worker-0", "demo-worker-1"]


def test_a_plan_seen_again_unmarked_is_not_reapplied_in_the_port():
    """The port's reconciler applies a plan once even when its
    ``Succeeded`` mark did not land (here: the store refuses the status
    write); a later spec change still moves the pods."""
    port = PKGS["torch"]

    class NoStatus(port.kube.FakeKubeApi):
        def update_status(self, *a, **k):
            raise RuntimeError("status writes refused")

    api = NoStatus()
    job = demo_job(port, replicas=1, max_hosts=4)
    rec = port.kube.JobReconciler(api, job)
    api.create(job.to_manifest())
    rec._reconcile(port.kube.WatchEvent("ADDED",
                                        api.get("ElasticJob", "demo")))
    api.create(port.crd.ScalePlanCRD(job_name="demo", name="sp-1",
                                     replica_counts={"worker": 3})
               .to_manifest())
    plan = api.get("ScalePlan", "sp-1")
    rec._reconcile(port.kube.WatchEvent("ADDED", plan))
    assert len(api.list("Pod")) == 3
    ej = api.get("ElasticJob", "demo")
    ej["spec"]["replicaSpecs"]["worker"]["replicas"] = 2
    api.update(ej)
    rec._reconcile(port.kube.WatchEvent("MODIFIED",
                                        api.get("ElasticJob", "demo")))
    assert len(api.list("Pod")) == 2
    rec._reconcile(port.kube.WatchEvent("MODIFIED", plan))  # a relist
    assert len(api.list("Pod")) == 2


# ---- the CRDs and the scaler ---------------------------------------------


def _tpu_job(pkg, hosts_per_slice=4, min_hosts=4, max_hosts=16):
    return pkg.crd.ElasticJob(
        name="gpt-train",
        spec=pkg.crd.ElasticJobSpec(
            min_hosts=min_hosts, max_hosts=max_hosts,
            replica_specs={"worker": pkg.crd.ReplicaSpec(
                replicas=min_hosts, command=["python", "train.py"],
                env={"A": "1"}, secret_env={"T": ("s", "k")},
                slice=pkg.slice_cls(hosts_per_slice=hosts_per_slice))}))


def test_the_elastic_job_manifest_differs_only_in_the_named_keys():
    jm = _tpu_job(PKGS["jax"]).to_manifest()
    pm = _tpu_job(PKGS["torch"]).to_manifest()
    jtpl = jm["spec"]["replicaSpecs"]["worker"]["template"]
    ptpl = pm["spec"]["replicaSpecs"]["worker"]["template"]
    assert set(jtpl["spec"].pop("nodeSelector")) == {
        "cloud.google.com/gke-tpu-accelerator",
        "cloud.google.com/gke-tpu-topology"}
    assert ptpl["spec"].pop("nodeSelector") == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    jres = jtpl["spec"]["containers"][0].pop("resources")
    pres = ptpl["spec"]["containers"][0].pop("resources")
    assert jres["requests"].pop("google.com/tpu") == "4"
    assert jres["limits"].pop("google.com/tpu") == "4"
    assert pres["requests"].pop("nvidia.com/gpu") == "8"
    assert pres["limits"].pop("nvidia.com/gpu") == "8"
    assert pres == jres
    assert pm == jm


@pytest.mark.parametrize("kind", ["job", "plan"])
def test_render_yaml_reads_back_as_the_manifest(kind):
    """The port writes JSON, which is YAML: ``yaml.safe_load`` reads it
    back as the manifest, as it reads the JAX package's YAML; a plan
    (no node keys) reads back as the JAX package's."""
    yaml = pytest.importorskip("yaml")
    back = {}
    for name in ("jax", "torch"):
        pkg = PKGS[name]
        obj = _tpu_job(pkg) if kind == "job" else pkg.crd.ScalePlanCRD(
            job_name="gpt-train", replica_counts={"worker": 8},
            remove_pods=["gpt-train-worker-9"])
        back[name] = yaml.safe_load(obj.render_yaml())
        assert back[name] == obj.to_manifest(), name
    assert json.loads(obj.render_yaml()) == back["torch"]
    if kind == "plan":
        assert back["torch"] == back["jax"]


def test_the_manifest_round_trips_through_from_manifest():
    for name in ("jax", "torch"):
        pkg = PKGS[name]
        job = _tpu_job(pkg, hosts_per_slice=2, max_hosts=8)
        job.spec.optimize_mode = "cluster"
        back = pkg.crd.ElasticJob.from_manifest(job.to_manifest())
        assert back == job, name


def test_snap_to_slices_is_the_jax_rule():
    for hosts in range(0, 18):
        for hps in (1, 2, 4):
            for minimum in (0, 1, 4):
                assert PKGS["torch"].scaler.snap_to_slices(
                    hosts, hps, minimum) == PKGS["jax"].scaler.snap_to_slices(
                    hosts, hps, minimum)


def _scaler_sequence(pkg, max_hosts, hps, min_hosts, targets, remove=(),
                     relaunch=()):
    created, deleted = [], []
    job = _tpu_job(pkg, hosts_per_slice=hps, min_hosts=min_hosts,
                   max_hosts=max_hosts)
    scaler = pkg.scaler.SliceScaler(job, submit_fn=created.append,
                                    delete_fn=deleted.append,
                                    master_addr="10.0.0.2:5001")
    crds = []
    for target in targets:
        plan = pkg.nm.ScalePlan()
        plan.worker_num = target
        scaler.scale(plan)
        crds.append(scaler.to_scale_plan_crd(plan).to_manifest())
    if remove:
        plan = pkg.nm.ScalePlan()
        plan.remove_nodes = [pkg.node.Node(node_type="worker", node_id=i,
                                           name=f"w-{i}") for i in remove]
        crds.append(scaler.to_scale_plan_crd(plan).to_manifest())
        scaler.scale(plan)
    for i, inc in relaunch:
        node = pkg.node.Node(node_type="worker", node_id=i)
        node.incarnation = inc
        plan = pkg.nm.ScalePlan()
        plan.launch_nodes = [node]
        scaler.scale(plan)
    return {"created": [normal_pod(m) for m in created],
            "deleted": deleted, "hosts": scaler.live_hosts, "crds": crds}


_SCALER_CASES = {
    "slice_aligned": (16, 4, 4, [5, 4], (), ()),
    "max_hosts": (8, 4, 4, [100], (), ()),
    "max_cap_rounds_down": (6, 4, 4, [100], (), ()),
    "remove_node": (16, 1, 1, [3], (1,), ()),
    "relaunch_keeps_index": (16, 1, 1, [3], (), ((1, 1), (2, 3))),
    "grow_and_shrink": (16, 2, 2, [1, 7, 3, 0], (), ()),
}


@pytest.mark.parametrize("case", sorted(_SCALER_CASES))
def test_the_slice_scaler_makes_the_jax_pods(case):
    args = _SCALER_CASES[case]
    jax = _scaler_sequence(PKGS["jax"], *args)
    port = _scaler_sequence(PKGS["torch"], *args)
    assert port == jax
    if case == "slice_aligned":
        assert port["hosts"] == [0, 1, 2, 3] and len(port["deleted"]) == 4
        assert port["crds"][0]["spec"]["replicaCounts"]["worker"] == 8
    if case == "max_cap_rounds_down":
        assert len(port["created"]) == 4
    if case == "remove_node":
        assert port["deleted"] == ["gpt-train-worker-1"]
        assert port["hosts"] == [0, 2]
    if case == "relaunch_keeps_index":
        assert [m["metadata"]["name"] for m in port["created"][3:]] == [
            "gpt-train-worker-1-r1", "gpt-train-worker-2-r3"]


def test_a_scaler_refuses_a_cap_below_one_slice():
    for name in ("jax", "torch"):
        pkg = PKGS[name]
        with pytest.raises(ValueError, match="cannot fit one slice"):
            pkg.scaler.SliceScaler(_tpu_job(pkg, max_hosts=3))


def test_an_existing_pod_is_adopted_and_other_errors_raise():
    for name in ("jax", "torch"):
        pkg = PKGS[name]
        api = pkg.kube.FakeKubeApi()
        job = demo_job(pkg, replicas=1)
        first = pkg.scaler.SliceScaler(job, submit_fn=api.create)
        plan = pkg.nm.ScalePlan()
        plan.worker_num = 1
        first.scale(plan)
        again = pkg.scaler.SliceScaler(job, submit_fn=api.create)
        again.scale(plan)
        assert again.live_hosts == [0]

        def refuse(manifest):
            raise PermissionError("403 forbidden")

        with pytest.raises(PermissionError):
            pkg.scaler.SliceScaler(job, submit_fn=refuse).scale(plan)


# ---- the node id -----------------------------------------------------------


def _launcher_node_ids(pkg, agent_mod, monkeypatch):
    """Two hosts' pods; each pod's node id as its package's launcher
    resolves it from the pod's env alone (no ``--node-id``)."""
    job = demo_job(pkg, replicas=2)
    rs = job.spec.replica_specs["worker"]
    ids = []
    for host in (0, 1):
        pod = pkg.crd.pod_manifest("demo", "worker", rs, host_index=host,
                                   slice_index=host)
        env = {e["name"]: e["value"]
               for e in pod["spec"]["containers"][0]["env"]}
        with monkeypatch.context() as m:
            m.delenv("DLROVER_TPU_NODE_ID", raising=False)
            for k, v in env.items():
                m.setenv(k, v)
            config = agent_mod.ElasticLaunchConfig()
            config.auto_configure()
            ids.append(config.node_id)
    return ids


def test_two_pods_are_nodes_0_and_1_in_the_port_and_both_0_in_jax(
        monkeypatch):
    """The repair: a pod template is shared by every replica and cannot
    carry ``--node-id``; the launcher reads ``DLROVER_TPU_NODE_ID``. The
    JAX manifest sets only ``DLROVER_TPU_NODE_RANK``, so both of a JAX
    job's pods register as node 0; the port's pods are nodes 0 and 1, a
    relaunched pod keeping its index."""
    import dlrover_tpu.agent.agent as jagent

    from dlrover_tpu_torch.agent import agent

    assert _launcher_node_ids(PKGS["jax"], jagent, monkeypatch) == [0, 0]
    assert _launcher_node_ids(PKGS["torch"], agent, monkeypatch) == [0, 1]
    rs = demo_job(PKGS["torch"]).spec.replica_specs["worker"]
    pod = PKGS["torch"].crd.pod_manifest("demo", "worker", rs, 1, 1,
                                         attempt=2)
    env = {e["name"]: e["value"] for e in pod["spec"]["containers"][0]["env"]}
    assert pod["metadata"]["name"] == "demo-worker-1-r2"
    assert env["DLROVER_TPU_NODE_ID"] == env["DLROVER_TPU_NODE_RANK"] == "1"
