"""The Ray adapter (``cluster/ray.py``) against the JAX package's, on the
CPU: ``RayJobsApi`` and ``RayJobSubmitter`` against a stdlib server
speaking Ray's ``/api/jobs/`` REST protocol, and the same ScalePlans
through each package's ``SliceScaler`` give the same Ray jobs (but for
the port's node id variable and its default entrypoint, the port's
launcher). The cases of the JAX package's ``tests/test_ray.py``.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from torch_cluster_util import PORT_ONLY_ENV, demo_job, packages

PKGS = packages()


class _RayHandler(BaseHTTPRequestHandler):
    """Ray's Jobs API over the server's ``jobs`` dict."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, code, obj):
        raw = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n)) if n else {}
        jobs = self.server.jobs
        if self.path == "/api/jobs/":
            sid = body["submission_id"]
            if sid in jobs:
                self._send(400, {"error": "exists"})
                return
            jobs[sid] = {"submission_id": sid, "status": "RUNNING",
                         "entrypoint": body["entrypoint"],
                         "runtime_env": body.get("runtime_env", {}),
                         "metadata": body.get("metadata", {}),
                         "resources": body.get("entrypoint_resources")}
            self._send(200, {"submission_id": sid})
        elif self.path.endswith("/stop"):
            sid = self.path.split("/")[-2]
            if sid not in jobs:
                self._send(404, {})
                return
            jobs[sid]["status"] = "STOPPED"
            self._send(200, {"stopped": True})
        else:
            self._send(404, {})

    def do_GET(self):  # noqa: N802
        jobs = self.server.jobs
        if self.path == "/api/jobs/":
            self._send(200, list(jobs.values()))
            return
        sid = self.path.split("/")[-1]
        if sid in jobs:
            self._send(200, jobs[sid])
        else:
            self._send(404, {})

    def do_DELETE(self):  # noqa: N802
        sid = self.path.split("/")[-1]
        if self.server.jobs.pop(sid, None) is None:
            self._send(404, {})
        else:
            self._send(200, {})


@pytest.fixture()
def ray_server():
    """A fresh Jobs API server for each package: {name: (jobs, url)}."""
    servers = {}
    for name in ("jax", "torch"):
        server = ThreadingHTTPServer(("127.0.0.1", 0), _RayHandler)
        server.daemon_threads = True
        server.jobs = {}
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers[name] = server
    yield {n: (s.jobs, f"http://127.0.0.1:{s.server_address[1]}")
           for n, s in servers.items()}
    for s in servers.values():
        s.shutdown()
        s.server_close()


def _roundtrip(pkg, url):
    api = pkg.ray.RayJobsApi(url)
    out = [api.submit("w0", "python agent.py", env={"A": "1"},
                      metadata={"r": "0"}, resources={"GPU": 1.0}),
           api.status("w0"), [j["submission_id"] for j in api.list()],
           api.stop("w0"), api.status("w0")]
    api.delete("w0")
    out += [api.status("w0"), api.stop("gone")]
    api.delete("gone")
    return out


def test_the_jobs_api_round_trips_as_jax(ray_server):
    jax = _roundtrip(PKGS["jax"], ray_server["jax"][1])
    port = _roundtrip(PKGS["torch"], ray_server["torch"][1])
    assert port == jax == ["w0", "RUNNING", ["w0"], True, "STOPPED", None,
                           False]


def _through_the_scaler(pkg, jobs, url):
    sub = pkg.ray.RayJobSubmitter(pkg.ray.RayJobsApi(url),
                                  master_addr="10.0.0.1:8000", run_id="r77",
                                  resources={"GPU": 1.0})
    scaler = pkg.scaler.SliceScaler(
        demo_job(pkg), submit_fn=sub.submit, delete_fn=sub.delete,
        master_addr="10.0.0.1:8000")
    trace = []
    for target in (2, 3, 1):
        plan = pkg.nm.ScalePlan()
        plan.worker_num = target
        scaler.scale(plan)
        trace.append((sorted(jobs), sorted(sub.live_jobs())))
    relaunch = pkg.node.Node(node_type="worker", node_id=0)
    relaunch.incarnation = 1
    plan = pkg.nm.ScalePlan()
    plan.launch_nodes = [relaunch]
    scaler.scale(plan)
    trace.append((sorted(jobs), sorted(sub.live_jobs())))
    own = {}  # what differs: the node id and the entrypoint
    for sid, job in jobs.items():
        env = job["runtime_env"]["env_vars"]
        own[sid] = ([env.pop(key, None) for key in PORT_ONLY_ENV],
                    job.pop("entrypoint"))
    return trace, jobs, own


def test_the_slice_scaler_drives_the_jax_ray_jobs(ray_server):
    """The same ScalePlans (grow to 2 and 3, shrink to 1, relaunch node
    0) submit, stop and remove the same Ray jobs with the same env and
    metadata; the port's job runs its launcher and knows its node id."""
    *jax, jax_own = _through_the_scaler(PKGS["jax"], *ray_server["jax"])
    port_jobs = ray_server["torch"][0]
    *port, port_own = _through_the_scaler(PKGS["torch"],
                                          *ray_server["torch"])
    assert port == jax
    assert jax_own == {"demo-worker-0-r1": (
        [None], "python -m dlrover_tpu.agent.agent")}
    assert port_own == {"demo-worker-0-r1": (
        ["0"], "python -m dlrover_tpu_torch.agent.launcher")}
    trace, jobs = port
    assert trace[0] == (["demo-worker-0", "demo-worker-1"],) * 2
    assert trace[-1][0] == ["demo-worker-0-r1"]
    env = jobs["demo-worker-0-r1"]["runtime_env"]["env_vars"]
    assert env["DLROVER_MASTER_ADDR"] == "10.0.0.1:8000"
    assert env["DLROVER_TPU_RUN_ID"] == "r77"
    assert jobs["demo-worker-0-r1"]["metadata"][
        "elasticjob.dlrover/rank-index"] == "0"
    assert port_jobs is jobs
