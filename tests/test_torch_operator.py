"""The port's operator (``cluster/operator.py``) against the JAX
package's, on the CPU, each on its own ``FakeKubeApi``: the cases of the
JAX package's ``tests/test_operator.py`` but for its ``deploy/``
manifests (they name TPU resources; the port's are still to come).

The same ElasticJobs give the same master pod (but for its command's
program and the device keys), Service, wire-token Secret, worker pods,
status, Events and teardown; the lease and the health server answer
alike. The operator's entry point runs as its own process against the
port's HTTP API server double (``chip_smoke.KubeFacade``). Pinned
differences: the default master command is the port's entry point; the
teardown also deletes the job's ScalePlans; and a status write does not
undo a ScalePlan (``cluster/kube.py``'s repair), so a job the operator
grew keeps its pod under the status loop.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from torch_cluster_util import (
    chip_smoke,
    demo_job,
    normal_pod,
    packages,
    wait,
)

PKGS = packages()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _job(pkg, name="demo", replicas=2, max_hosts=4):
    return demo_job(pkg, name=name, replicas=replicas, max_hosts=max_hosts,
                    env={"FOO": "bar"})


def _env(pod):
    return {e["name"]: e for e in pod["spec"]["containers"][0]["env"]}


def _normal(obj):
    """A stored object without its resourceVersion and with the device
    keys and the port's node id dropped; a minted token as ``<token>``
    and an Event's random name suffix as ``<id>``."""
    obj = normal_pod(obj)
    if obj.get("kind") == "Secret":
        obj["stringData"] = {"token": "<token>"}
    if obj.get("kind") == "Event":
        obj["metadata"]["name"] = obj["metadata"]["name"].split(".")[0] \
            + ".<id>"
        if obj["reason"] == "TornDown":  # the port's names scale plans
            obj["message"] = "<torn down>"
    return obj


def _snapshot(api, kinds=("Pod", "Service", "Secret", "Event")):
    """The stored objects in normal form; Events (named by a random
    suffix) in the order of their job and reason."""
    out = {k: [_normal(o) for o in api.list(k)] for k in kinds}
    if "Event" in out:
        out["Event"].sort(key=lambda e: (e["involvedObject"]["name"],
                                         e["reason"]))
    return out


def _fan_out(pkg):
    api = pkg.kube.FakeKubeApi()
    ctl = pkg.operator.OperatorController(api)
    ctl.start()
    try:
        api.create(_job(pkg, "j1", replicas=2).to_manifest())
        wait(lambda: api.get("Pod", "j1-worker-1") is not None)
        api.create(_job(pkg, "j2", replicas=1).to_manifest())
        wait(lambda: api.get("Pod", "j2-worker-0") is not None)
        jobs = ctl.jobs()
        before = _snapshot(api)
        api.delete("ElasticJob", "j1")
        wait(lambda: not api.list("Pod", label_selector={
            pkg.kube.JOB_LABEL: "j1"}))
        wait(lambda: ctl.jobs() == ["j2"])
        after = _snapshot(api)
    finally:
        ctl.stop()
    return {"jobs": jobs, "before": before, "after": after}


def _master_command_program(snapshot_pods):
    """Each master pod's command with its program cut off, and the
    programs."""
    programs = []
    for pod in snapshot_pods:
        if pod["metadata"]["name"].endswith("-master"):
            cmd = pod["spec"]["containers"][0]["command"]
            cut = cmd.index("--port")
            programs.append(cmd[:cut])
            pod["spec"]["containers"][0]["command"] = cmd[cut:]
    return programs


def test_the_operator_fans_out_and_tears_down_as_jax():
    jax, port = _fan_out(PKGS["jax"]), _fan_out(PKGS["torch"])
    for snap in ("before", "after"):
        assert _master_command_program(jax[snap]["Pod"]) == [
            ["dlrover-tpu-master"]] * (2 if snap == "before" else 1)
        assert _master_command_program(port[snap]["Pod"]) == [
            ["python", "-m", "dlrover_tpu_torch.master.main"]] * (
            2 if snap == "before" else 1)
    assert port == jax
    env = _env([p for p in port["before"]["Pod"]
                if p["metadata"]["name"] == "j1-worker-0"][0])
    assert env["DLROVER_TPU_MASTER_ADDR"]["value"] == \
        "j1-master.default.svc:8600"
    assert port["jobs"] == ["j1", "j2"]
    assert sorted(p["metadata"]["name"] for p in port["after"]["Pod"]) == [
        "j2-master", "j2-worker-0"]


def _relist_gap(pkg):
    api = pkg.kube.FakeKubeApi()
    ctl = pkg.operator.OperatorController(api)
    api.create(_job(pkg, "gap", replicas=1).to_manifest())
    since = ctl._adopt_current()
    jobs = ctl.jobs()
    wait(lambda: api.get("Pod", "gap-worker-0") is not None)
    api.delete("ElasticJob", "gap")
    ctl._adopt_current()
    out = {"since": since, "jobs": jobs, "after": ctl.jobs(),
           "pods": api.list("Pod")}
    ctl.stop()
    return out


def test_a_relist_tears_down_a_job_deleted_in_the_gap_as_jax():
    jax, port = _relist_gap(PKGS["jax"]), _relist_gap(PKGS["torch"])
    assert port == jax
    assert port["jobs"] == ["gap"] and port["after"] == []
    assert port["since"] > 0 and port["pods"] == []


@pytest.mark.parametrize("brain", ["brain.svc:8600", ""])
@pytest.mark.parametrize("declared", [None, ["my-master", "--port", "8600"],
                                      ["my-master", "--brain-addr", "o:1"],
                                      []])
@pytest.mark.parametrize("mode", ["cluster", "single-job"])
def test_the_master_pod_is_the_jax_master_pod(mode, declared, brain):
    """The master pod, its command's Brain flags (appended to a declared
    command, kept when already there, left out without an address)
    and the Service: the JAX operator's but for the default command's
    program and the device keys; the declared spec is not mutated."""
    out = {}
    for name in ("jax", "torch"):
        pkg = PKGS[name]
        job = _job(pkg, "br", replicas=1)
        job.spec.optimize_mode = mode
        if declared is not None:
            job.spec.replica_specs["master"] = pkg.crd.ReplicaSpec(
                replicas=1, command=list(declared))
        pod = normal_pod(pkg.operator.master_pod_manifest(
            job, brain_addr=brain))
        cmd = pod["spec"]["containers"][0]["command"]
        if declared is None:
            program = ["dlrover-tpu-master"] if name == "jax" else [
                "python", "-m", "dlrover_tpu_torch.master.main"]
            assert cmd[:len(program)] == program
            pod["spec"]["containers"][0]["command"] = cmd[len(program):]
        else:
            assert job.spec.replica_specs["master"].command == declared
        out[name] = (pod, pkg.operator.master_service_manifest(job))
    assert out["torch"] == out["jax"]
    cmd = out["torch"][0]["spec"]["containers"][0]["command"]
    if mode == "cluster" and brain and cmd and declared != [
            "my-master", "--brain-addr", "o:1"]:
        assert cmd[-4:] == ["--optimize-mode", "cluster", "--brain-addr",
                            brain]
    else:
        assert cmd.count("--brain-addr") == int(declared == [
            "my-master", "--brain-addr", "o:1"])
    assert "nodeSelector" not in out["torch"][0]["spec"]


def _status(pkg):
    api = pkg.kube.FakeKubeApi()
    ctl = pkg.operator.OperatorController(api, status_interval_s=0.2)
    ctl.start()
    seen = []
    try:
        api.create(_job(pkg, "st", replicas=2).to_manifest())
        wait(lambda: (api.get("ElasticJob", "st") or {}).get(
            "status", {}).get("phase") == "Pending")
        seen.append(api.get("ElasticJob", "st")["status"])
        api.set_pod_phase("st-worker-0", "Running")
        wait(lambda: api.get("ElasticJob", "st")["status"]["phase"]
             == "Running")
        seen.append(api.get("ElasticJob", "st")["status"])
        rv1 = api.get("ElasticJob", "st")["metadata"]["resourceVersion"]
        time.sleep(0.8)
        rv2 = api.get("ElasticJob", "st")["metadata"]["resourceVersion"]
        for pod in ("st-worker-0", "st-worker-1"):
            api.set_pod_phase(pod, "Failed", reason="OOMKilled")
        wait(lambda: api.get("ElasticJob", "st")["status"]["phase"]
             == "Failed")
        seen.append(api.get("ElasticJob", "st")["status"])
        computed = ctl.compute_status("st")
    finally:
        ctl.stop()
    return {"seen": seen, "unchanged": rv1 == rv2, "computed": computed}


def test_the_job_status_follows_the_pods_as_jax():
    jax, port = _status(PKGS["jax"]), _status(PKGS["torch"])
    assert port == jax
    assert port["unchanged"]
    assert port["seen"][1]["replicaStatuses"]["worker"] == {
        "Running": 1, "Pending": 1}


def _events_and_token(pkg):
    api = pkg.kube.FakeKubeApi()
    ctl = pkg.operator.OperatorController(api)
    api.create(_job(pkg, "tok", replicas=2).to_manifest())
    ctl._adopt_current()
    wait(lambda: api.get("Pod", "tok-worker-1") is not None)
    token = api.get("Secret", "tok-wire-token")["stringData"]["token"]
    envs = {p: _env(api.get("Pod", p)) for p in (
        "tok-worker-0", "tok-worker-1", "tok-master")}
    ctl.stop()
    ctl2 = pkg.operator.OperatorController(api)
    ctl2._adopt_current()
    kept = api.get("Secret", "tok-wire-token")["stringData"]["token"]
    ctl2._teardown("tok", uid="u-1")
    events = sorted((e["reason"], e["involvedObject"], e["message"])
                    for e in api.list("Event"))
    ctl2.stop()
    return {"len": len(token), "kept": kept == token, "events": events,
            "secret_after": api.get("Secret", "tok-wire-token"),
            "refs": {p: (e["DLROVER_TPU_WIRE_TOKEN"]["valueFrom"],
                         "value" in e["DLROVER_TPU_WIRE_TOKEN"],
                         e["DLROVER_TPU_RUN_ID"]["value"])
                     for p, e in envs.items()}}


def test_the_wire_token_and_the_events_are_the_jax_operators():
    jax, port = (_events_and_token(PKGS["jax"]),
                 _events_and_token(PKGS["torch"]))
    # the teardown's message names what the port's also removes
    jax_events = [e[:2] for e in jax.pop("events")]
    port_events = port.pop("events")
    assert [e[:2] for e in port_events] == jax_events
    assert [e[2] for e in port_events if e[0] == "TornDown"] == [
        "pods, scale plans, service and wire-token removed"]
    assert port == jax
    assert port["len"] >= 32 and port["kept"]
    assert port["secret_after"] is None
    for ref, plain, run_id in port["refs"].values():
        assert ref == {"secretKeyRef": {"name": "tok-wire-token",
                                        "key": "token"}}
        assert not plain and run_id == "tok"


def _teardown_plans(pkg):
    api = pkg.kube.FakeKubeApi()
    ctl = pkg.operator.OperatorController(api)
    api.create(_job(pkg, "sp", replicas=1, max_hosts=2).to_manifest())
    ctl._adopt_current()
    api.create(pkg.crd.ScalePlanCRD(job_name="sp", name="sp-plan-1",
                                    replica_counts={"worker": 2})
               .to_manifest())
    wait(lambda: api.get("Pod", "sp-worker-1") is not None)
    ctl._teardown("sp")
    ctl.stop()
    return [p["metadata"]["name"] for p in api.list("ScalePlan")]


def test_the_teardown_also_deletes_the_jobs_scale_plans_in_the_port():
    """A ScalePlan left after its job would be replayed on a new job of
    the same name; the API server's garbage collector deletes what a job
    owns, and the port's teardown does (the JAX one leaves it)."""
    assert _teardown_plans(PKGS["jax"]) == ["sp-plan-1"]
    assert _teardown_plans(PKGS["torch"]) == []


def _grown_under_the_status_loop(pkg):
    api = pkg.kube.FakeKubeApi()
    ctl = pkg.operator.OperatorController(api, status_interval_s=0.1)
    ctl.start()
    try:
        api.create(_job(pkg, "g", replicas=1, max_hosts=2).to_manifest())
        wait(lambda: api.get("Pod", "g-worker-0") is not None)
        api.set_pod_phase("g-worker-0", "Running")
        api.create(pkg.crd.ScalePlanCRD(job_name="g", name="g-plan-1",
                                        replica_counts={"worker": 2})
                   .to_manifest())
        wait(lambda: api.get("Pod", "g-worker-1") is not None)
        api.set_pod_phase("g-worker-1", "Running")

        def workers():
            return sorted(p["metadata"]["name"] for p in api.list(
                "Pod", label_selector={"elasticjob.dlrover/replica-type":
                                       "worker"}))

        # the status write with both running, then time for the
        # reconciler to act on it (a deletion ends the wait early)
        wait(lambda: len(workers()) == 1 or api.get("ElasticJob", "g").get(
            "status", {}).get("replicaStatuses", {}).get("worker", {}).get(
                "Running") == 2)
        deadline = time.time() + 3.0
        while time.time() < deadline and len(workers()) == 2:
            time.sleep(0.05)
        return workers()
    finally:
        ctl.stop()


def test_a_grown_job_keeps_its_pod_under_the_status_loop_in_the_port():
    """The operator's status loop writes the job's status as its pods
    change; in the JAX operator that write re-applies the spec's one
    replica and deletes the pod the ScalePlan grew."""
    assert _grown_under_the_status_loop(PKGS["jax"]) == ["g-worker-0"]
    assert _grown_under_the_status_loop(PKGS["torch"]) == [
        "g-worker-0", "g-worker-1"]


def _lease(pkg):
    api = pkg.kube.FakeKubeApi()
    a = pkg.operator.LeaderElector(api, identity="op-a", ttl_s=0.4)
    b = pkg.operator.LeaderElector(api, identity="op-b", ttl_s=0.4)
    out = [a.try_acquire(), b.try_acquire(), b.held_by_other,
           a.try_acquire()]
    time.sleep(0.6)
    out += [b.try_acquire(), a.try_acquire(), a.held_by_other,
            api.get("ConfigMap", "dlrover-tpu-operator-leader")["data"][
                "holder"]]
    return out


def test_the_lease_is_acquired_renewed_and_stolen_as_jax():
    assert _lease(PKGS["torch"]) == _lease(PKGS["jax"]) == [
        True, False, True, True, True, False, True, "op-b"]


def _leader_loop(pkg):
    """``LeaderElector.run``: leads at once, steps down at stop."""
    api = pkg.kube.FakeKubeApi()
    elector = pkg.operator.LeaderElector(api, identity="solo", ttl_s=0.3)
    stop = threading.Event()
    calls = []
    t = threading.Thread(target=elector.run, args=(
        stop, lambda: calls.append("up"), lambda: calls.append("down")))
    t.start()
    wait(lambda: calls == ["up"])
    time.sleep(0.35)
    stop.set()
    t.join(5)
    return calls


def test_the_election_loop_leads_and_steps_down_as_jax():
    assert _leader_loop(PKGS["torch"]) == _leader_loop(PKGS["jax"]) == [
        "up", "down"]


def _health(pkg):
    api = pkg.kube.FakeKubeApi()
    ctl = pkg.operator.OperatorController(api)
    state = {"leading": False}
    health = pkg.operator.OperatorHealthServer(ctl, lambda: state["leading"],
                                               port=0)
    health.start()
    out = []
    try:
        base = f"http://127.0.0.1:{health.port}"
        for path, leading in (("/healthz", False), ("/readyz", False),
                              ("/readyz", True)):
            state["leading"] = leading
            with urllib.request.urlopen(base + path, timeout=5) as r:
                out.append((r.status, json.loads(r.read())))
        try:
            urllib.request.urlopen(base + "/nope", timeout=5)
        except urllib.error.HTTPError as e:
            out.append(e.code)
    finally:
        health.stop()
        ctl.stop()
    return out


def test_the_health_endpoints_answer_as_jax():
    assert _health(PKGS["torch"]) == _health(PKGS["jax"]) == [
        (200, {"leading": False, "jobs": []}),
        (200, {"leading": False, "jobs": []}),
        (200, {"leading": True, "jobs": []}), 404]


def test_the_operator_flags_are_the_jax_operators():
    argv = ["--kube-url", "http://x:1", "--namespace", "ns", "--token", "t",
            "--ca-path", "/ca", "--no-verify", "--master-port", "9000",
            "--brain-addr", "b:1", "--lease-ttl", "2", "--no-leader-elect",
            "--health-port", "-1"]
    for args in ([], argv):
        assert vars(PKGS["torch"].operator.parse_operator_args(args)) == \
            vars(PKGS["jax"].operator.parse_operator_args(args))


def test_the_operator_process_runs_a_job_over_http_and_stops_on_sigterm():
    """``python -m dlrover_tpu_torch.cluster.operator`` against the
    port's API server double: it takes the lease, an ElasticJob applied
    by another client becomes the master pod and the workers, a deleted
    job is torn down, and SIGTERM ends the process with 0."""
    cs = chip_smoke()
    facade = cs.KubeFacade("test-token")
    url = facade.start()
    health_port = cs._free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.cluster.operator",
         "--kube-url", url, "--token", "test-token", "--lease-ttl", "2",
         "--health-port", str(health_port)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        client = PKGS["torch"].http.RealKubeApi(url, token="test-token")
        client.create(_job(PKGS["torch"], "wired", replicas=2).to_manifest())
        wait(lambda: client.get("Pod", "wired-worker-1") is not None,
             timeout=60.0, msg="the operator created the workers")
        assert client.get("Pod", "wired-master") is not None
        lease = client.get("ConfigMap", "dlrover-tpu-operator-leader")
        assert lease and lease["data"]["holder"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{health_port}/healthz", timeout=5) as r:
            assert json.loads(r.read()) == {"leading": True,
                                            "jobs": ["wired"]}
        client.delete("ElasticJob", "wired")
        wait(lambda: not client.list("Pod") and client.get(
            "Secret", "wired-wire-token") is None, timeout=20.0,
            msg="the job torn down")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        facade.stop()
