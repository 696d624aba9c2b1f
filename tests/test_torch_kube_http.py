"""``RealKubeApi`` (``cluster/kube_http.py``) against the port's HTTP API
server double (``chip_smoke.KubeFacade``: the port's ``FakeKubeApi``
behind the Kubernetes REST protocol), on the CPU.

The cases of the JAX package's ``tests/test_kube_http.py``, each run
with each package's client and binding (``packages()``) against its own
façade, so the port's client is held to the JAX client's behaviour on
the same wire and the façade to the protocol the JAX client speaks:
CRUD and label selectors, the bearer token, chunked watches resumed from
their resourceVersion (opaque ones too, through bookmarks and dropped
streams), 410 Gone → ``WatchExpired`` and the relist that recovers from
it, the status subresource, the per-kind resume tokens of the merged
watch; and the pod watcher, job manager, slice scaler and reconciler run
unchanged over the wire.
"""

import threading
import time
import urllib.error

import pytest

from torch_cluster_util import chip_smoke, demo_job, packages, wait

PKGS = packages()
TOKEN = "test-token"


@pytest.fixture(params=["jax", "torch"])
def wire(request):
    """(package, its client on a fresh façade, the façade)."""
    facade = chip_smoke().KubeFacade(TOKEN)
    url = facade.start()
    pkg = PKGS[request.param]
    yield pkg, pkg.http.RealKubeApi(url, token=TOKEN), facade
    facade.stop()


def _names(api, kind="Pod", selector=None):
    return [p["metadata"]["name"]
            for p in api.list(kind, label_selector=selector)]


def test_crud_and_selectors_over_http(wire):
    pkg, api, _ = wire
    label = {pkg.kube.JOB_LABEL: "demo"}
    pod = {"kind": "Pod", "metadata": {"name": "p0", "labels": label}}
    assert api.create(pod)["metadata"]["name"] == "p0"
    with pytest.raises(urllib.error.HTTPError) as ei:
        api.create(pod)
    assert ei.value.code == 409
    assert api.get("Pod", "p0")["metadata"]["name"] == "p0"
    assert api.get("Pod", "nope") is None
    api.create({"kind": "Pod", "metadata": {"name": "p1", "labels": {}}})
    sel = api.list("Pod", label_selector=label)
    assert [p["metadata"]["name"] for p in sel] == ["p0"]
    assert all(p["kind"] == "Pod" for p in sel)
    api.delete("Pod", "p0")
    assert api.get("Pod", "p0") is None
    api.delete("Pod", "p0")  # a 404 is swallowed
    assert isinstance(api.list_rv("Pod"), int)
    with pytest.raises(KeyError, match="no registered API path"):
        api.list("Widget")


def test_a_request_without_the_token_is_refused(wire):
    pkg, api, facade = wire
    bad = pkg.http.RealKubeApi(facade.url, token="wrong")
    with pytest.raises(urllib.error.HTTPError) as ei:
        bad.list("Pod")
    assert ei.value.code == 401


def test_watch_streams_resume_and_410(wire):
    pkg, api, facade = wire
    fake = facade.fake
    api.create({"kind": "Pod", "metadata": {"name": "w0", "labels": {}}})
    stop = threading.Event()
    seen = []

    def consume():
        for ev in api.watch(kind="Pod", since_rv=0, stop=stop):
            seen.append((ev.type, ev.name, ev.resource_version))
            if len(seen) >= 3:
                return

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    fake.set_pod_phase("w0", "Running")
    fake.set_pod_phase("w0", "Failed", reason="OOMKilled")
    t.join(timeout=8)
    assert not t.is_alive()
    assert [s[0] for s in seen] == ["ADDED", "MODIFIED", "MODIFIED"]
    rvs = [s[2] for s in seen]
    assert rvs == sorted(rvs) and len(set(rvs)) == 3
    stop.set()
    facade.server.expire_below_rv = rvs[-1] + 100
    with pytest.raises(pkg.http.WatchExpired):
        next(iter(api.watch(kind="Pod", since_rv=1)))


def test_opaque_rvs_pass_through_and_bookmarks_are_skipped(wire):
    pkg, api, facade = wire
    server = facade.server
    server.rv_prefix, server.send_bookmarks = "op-", True
    server.drop_after_each = True
    stop = threading.Event()
    seen = []

    def consume():
        for ev in api.watch(kind="Pod", since_rv=0, stop=stop):
            seen.append((ev.type, ev.name, ev.resource_version))
            if len(seen) >= 3:
                return

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    api.create({"kind": "Pod", "metadata": {"name": "q0", "labels": {}}})
    facade.fake.set_pod_phase("q0", "Running")
    facade.fake.set_pod_phase("q0", "Failed", reason="OOMKilled")
    t.join(timeout=8)
    stop.set()
    assert not t.is_alive()
    assert [s[0] for s in seen] == ["ADDED", "MODIFIED", "MODIFIED"]
    assert [s[2] for s in seen] == [0, 0, 0]
    assert any(rv.startswith("op-") for _, rv in server.seen_watch_kind_rvs)
    assert api.list_rv("Pod").startswith("op-")


def test_the_merged_watch_resumes_each_kind_from_its_own_rv(wire):
    pkg, api, facade = wire
    stop = threading.Event()
    tokens = {"ElasticJob": "ej-token-7", "ScalePlan": "sp-token-42"}

    def consume():
        for _ in api.watch(kind=None, since_rv=tokens, stop=stop):
            pass

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    wait(lambda: len(facade.server.seen_watch_kind_rvs) >= 2)
    stop.set()
    t.join(5)
    assert dict(facade.server.seen_watch_kind_rvs[:2]) == tokens


def test_the_status_subresource_over_http(wire):
    pkg, api, _ = wire
    api.create({"kind": "ElasticJob", "metadata": {"name": "sj"},
                "spec": {"minHosts": 1}})
    obj = api.get("ElasticJob", "sj")
    obj["status"] = {"phase": "Hacked"}
    api.update(obj)
    assert (api.get("ElasticJob", "sj") or {}).get("status") is None
    api.update_status("ElasticJob", "sj", {"phase": "Running"})
    assert api.get("ElasticJob", "sj")["status"]["phase"] == "Running"
    obj = api.get("ElasticJob", "sj")
    obj["spec"]["minHosts"] = 3
    api.update(obj)
    api.update_status("ElasticJob", "sj", {"phase": "Failed"}, obj=obj)
    got = api.get("ElasticJob", "sj")
    assert got["spec"]["minHosts"] == 3
    assert got["status"]["phase"] == "Failed"
    assert api.update_status("ElasticJob", "gone", {}) is None


def _direct(pkg, api, replicas):
    job = demo_job(pkg, replicas=replicas)
    scaler = pkg.scaler.SliceScaler(
        job, submit_fn=api.create,
        delete_fn=lambda name: api.delete("Pod", name),
        master_addr="10.0.0.1:8000")
    jm = pkg.nm.JobManager(num_workers=replicas, relaunch_budget=2,
                           scaler=scaler)
    watcher = pkg.kube.PodWatcher(api, "demo", jm.process_event)
    plan = pkg.nm.ScalePlan()
    plan.worker_num = replicas
    scaler.scale(plan)
    return jm, watcher


def test_the_reconcile_loop_runs_over_the_wire(wire):
    """The master-direct loop of ``test_torch_kube.py`` with every API
    call over HTTP: an OOM-killed pod is relaunched once under its rank,
    and the predecessor's stale DELETED event is dropped."""
    pkg, api, facade = wire
    fake = facade.fake
    jm, watcher = _direct(pkg, api, 2)
    assert _names(api) == ["demo-worker-0", "demo-worker-1"]
    watcher.start()
    fake.set_pod_phase("demo-worker-0", "Running")
    fake.set_pod_phase("demo-worker-1", "Running")
    running = pkg.const.NodeStatus.RUNNING
    wait(lambda: all(jm.get_node(i).status == running for i in (0, 1)))
    fake.set_pod_phase("demo-worker-0", "Failed", reason="OOMKilled")
    wait(lambda: api.get("Pod", "demo-worker-0-r1") is not None)
    fake.set_pod_phase("demo-worker-0-r1", "Running")
    wait(lambda: jm.get_node(0).status == running)
    time.sleep(0.3)
    assert jm.get_node(0).relaunch_count == 1
    assert api.get("Pod", "demo-worker-0-r2") is None
    watcher.stop()
    jm.stop()


def test_the_pod_watcher_relists_after_a_410(wire):
    pkg, api, facade = wire
    fake, server = facade.fake, facade.server
    jm, watcher = _direct(pkg, api, 1)
    watcher.start()
    fake.set_pod_phase("demo-worker-0", "Running")
    wait(lambda: jm.get_node(0).status == pkg.const.NodeStatus.RUNNING)
    server.drop_streams = True
    server.expire_below_rv = fake.latest_rv() + 1
    time.sleep(0.5)
    server.drop_streams = False
    fake.set_pod_phase("demo-worker-0", "Failed", reason="OOMKilled")
    wait(lambda: api.get("Pod", "demo-worker-0-r1") is not None,
         timeout=10.0)
    assert jm.get_node(0).relaunch_count == 1
    watcher.stop()
    jm.stop()


def _ej(replicas):
    return {"kind": "ElasticJob", "metadata": {"name": "demo"},
            "spec": {"replicaSpecs": {"worker": {"replicas": replicas}}}}


def test_the_reconciler_runs_over_the_wire(wire):
    pkg, api, _ = wire
    rec = pkg.kube.JobReconciler(api, demo_job(pkg, replicas=0),
                                 master_addr="10.0.0.1:8000")
    rec.start()
    api.create(_ej(2))
    wait(lambda: len(api.list("Pod")) == 2)
    api.create({"kind": "ScalePlan", "metadata": {"name": "sp-1"},
                "spec": {"ownerJob": "demo", "replicaCounts": {"worker": 1},
                         "removePods": ["demo-worker-1"]}})
    wait(lambda: _names(api) == ["demo-worker-0"])
    wait(lambda: (api.get("ScalePlan", "sp-1") or {}).get("status") == {
        "phase": "Succeeded"})
    rec.stop()


def test_the_reconciler_relists_after_a_410(wire):
    pkg, api, facade = wire
    fake, server = facade.fake, facade.server
    rec = pkg.kube.JobReconciler(api, demo_job(pkg, replicas=0),
                                 master_addr="10.0.0.1:8000")
    rec.start()
    api.create(_ej(1))
    wait(lambda: len(api.list("Pod")) == 1)
    server.drop_streams = True
    server.expire_below_rv = fake.latest_rv() + 1
    time.sleep(0.5)
    server.drop_streams = False
    ej = api.get("ElasticJob", "demo")
    ej["spec"]["replicaSpecs"]["worker"]["replicas"] = 3
    api.update(ej)
    wait(lambda: len(api.list("Pod")) == 3, timeout=10.0)
    rec.stop()


def test_the_facade_stops_its_watch_streams():
    """``KubeFacade.stop`` ends the streams it serves: a client's watch
    sees its connection end."""
    cs = chip_smoke()
    facade = cs.KubeFacade(TOKEN)
    url = facade.start()
    api = PKGS["torch"].http.RealKubeApi(url, token=TOKEN, timeout_s=2.0)
    stop = threading.Event()
    ended = []

    def follow():
        try:
            list(api.watch(kind="Pod", stop=stop))
        except OSError as e:  # the server is gone when it reconnects
            ended.append(type(e).__name__)

    t = threading.Thread(target=follow, daemon=True)
    t.start()
    wait(lambda: facade.server.seen_watch_kind_rvs)
    facade.stop()
    stop.set()
    t.join(10)
    assert not t.is_alive()
