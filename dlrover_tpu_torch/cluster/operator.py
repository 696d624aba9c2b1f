"""The operator: the deployable controller process
(``python -m dlrover_tpu_torch.cluster.operator``).

Port of ``dlrover_tpu/cluster/operator.py`` (reference: the Go
operator's entrypoint and packaging — dlrover/go/operator/main.go,
manager + leader election over a Lease, controllers registered per CRD).
The reconcile logic is ``cluster/kube.py:JobReconciler``; this module
adds what deployment needs around it —

- **OperatorController**: a namespace-wide ElasticJob watch that spawns
  one JobReconciler per job (the Go manager's controller fan-out),
  creates the job's master pod + Service first so workers get
  ``DLROVER_TPU_MASTER_ADDR`` injected (docs/kubernetes.md flow), and
  tears the job down on DELETED.
- **LeaderElector**: ConfigMap-held lease with holder + renew
  timestamps (leader-election-lite — the Go operator uses a
  coordination/v1 Lease the same way: acquire, renew at ttl/3, steal
  when stale).
- **main()**: argparse → RealKubeApi (in-cluster defaults) → elect →
  run; SIGTERM (a Deployment's pod being stopped) stops the election
  loop and the controller, and the process exits 0.

A job's default master runs ``python -m dlrover_tpu_torch.master.main``
in a CPU pod. Where the JAX teardown deletes a job's pods, Service and
wire-token Secret, this one also deletes the job's ScalePlans (what the
API server's garbage collector does for objects a job owns): a plan
left behind would be replayed on a new job of the same name. The JAX
package's ``deploy/`` manifests name TPU resources; the port's own are
still to come.
"""

import argparse
import dataclasses
import os
import signal
import socket
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.cluster.crd import (
    GPU_RESOURCE,
    ElasticJob,
    ReplicaSpec,
    pod_template,
)
from dlrover_tpu_torch.cluster.kube import (
    JOB_LABEL,
    JobReconciler,
    KubeApi,
    WatchEvent,
    WatchExpired,
)
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

MASTER_PORT = 8600


def master_pod_manifest(
    job: ElasticJob, port: int = MASTER_PORT, brain_addr: str = ""
) -> Dict:
    """The job-master pod: created before any worker so the reconciler
    can inject its address (reference: the Go operator's master replica,
    elasticjob_controller.go creating the master pod first).
    ``optimizeMode: cluster`` jobs get ``--optimize-mode cluster
    --brain-addr`` so the master actually consults the shared brain."""
    rs = job.spec.replica_specs.get("master")
    if rs is not None and job.spec.optimize_mode == "cluster":
        # a user-declared master spec is used verbatim — but its
        # optimizeMode=cluster must not be silently ignored: append the
        # brain flags when the command doesn't already carry them
        if brain_addr and rs.command and (
            "--brain-addr" not in rs.command
        ):
            rs = dataclasses.replace(
                rs,
                command=list(rs.command)
                + ["--optimize-mode", "cluster", "--brain-addr", brain_addr],
            )
            logger.info(
                "ElasticJob %s: appended --optimize-mode cluster "
                "--brain-addr to the user-supplied master command",
                job.name,
            )
        elif not brain_addr:
            logger.warning(
                "ElasticJob %s declares a master spec with "
                "optimizeMode=cluster but the operator has no "
                "--brain-addr; the master will run single-job",
                job.name,
            )
        elif not rs.command:
            # image-entrypoint master (command=[]): flags can't be
            # appended without clobbering the entrypoint contract —
            # don't silently ignore the optimizeMode either
            logger.warning(
                "ElasticJob %s: optimizeMode=cluster with an "
                "image-entrypoint master spec (no command) — cannot "
                "inject --brain-addr %s; configure the image to read "
                "it, or declare an explicit command",
                job.name,
                brain_addr,
            )
    if rs is None:
        worker = job.spec.replica_specs.get("worker") or ReplicaSpec()
        command = [
            "python",
            "-m",
            "dlrover_tpu_torch.master.main",
            "--port",
            str(port),
            "--num-workers",
            str(worker.replicas),
            "--max-workers",
            str(job.spec.max_hosts),
            "--job-name",
            job.name,
        ]
        if job.spec.optimize_mode == "cluster":
            if brain_addr:
                command += [
                    "--optimize-mode", "cluster",
                    "--brain-addr", brain_addr,
                ]
            else:
                logger.warning(
                    "ElasticJob %s asks optimizeMode=cluster but the "
                    "operator has no --brain-addr; master runs "
                    "single-job",
                    job.name,
                )
        rs = ReplicaSpec(
            replicas=1,
            image=worker.image,
            command=command,
            cpu="2",
            memory="4Gi",
            # the worker env carries the run id + the wire-token
            # secretKeyRef; the master joins the same auth'd planes
            env=dict(worker.env),
            secret_env=dict(worker.secret_env),
        )
    tpl = pod_template(job.name, "master", rs)
    # the master is a CPU pod: no GPU request, no node pinning
    tpl["spec"].pop("nodeSelector", None)
    res = tpl["spec"]["containers"][0]["resources"]
    res["requests"].pop(GPU_RESOURCE, None)
    res["limits"].pop(GPU_RESOURCE, None)
    tpl["metadata"]["name"] = f"{job.name}-master"
    tpl["metadata"]["namespace"] = job.namespace
    return {"apiVersion": "v1", "kind": "Pod", **tpl}


def master_service_manifest(job: ElasticJob, port: int = MASTER_PORT) -> Dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": f"{job.name}-master",
            "namespace": job.namespace,
            "labels": {JOB_LABEL: job.name},
        },
        "spec": {
            "selector": {
                JOB_LABEL: job.name,
                "elasticjob.dlrover/replica-type": "master",
            },
            "ports": [{"port": port, "targetPort": port}],
        },
    }


class LeaderElector:
    """ConfigMap-held lease: one active operator per namespace.

    The Go operator leans on controller-runtime's Lease-based election
    (main.go ``LeaderElection: true``); the same acquire/renew/steal
    protocol here runs over a ConfigMap so it needs no extra API group.
    """

    def __init__(
        self,
        api: KubeApi,
        namespace: str = "default",
        name: str = "dlrover-tpu-operator-leader",
        identity: Optional[str] = None,
        ttl_s: float = 15.0,
    ):
        self._api = api
        self._ns = namespace
        self._name = name
        self.identity = identity or (
            f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        )
        self.ttl_s = ttl_s
        self.held_by_other = False

    def _manifest(self) -> Dict:
        return {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {"name": self._name, "namespace": self._ns},
            "data": {
                "holder": self.identity,
                "renew": repr(time.time()),
            },
        }

    def try_acquire(self) -> bool:
        """Acquire, renew, or steal-if-stale. False = not holding;
        ``self.held_by_other`` distinguishes an authoritative loss
        (another LIVE holder observed) from a transient API failure
        (which a current leader may ride out until its ttl passes)."""
        self.held_by_other = False
        try:
            cm = self._api.get("ConfigMap", self._name, self._ns)
            if cm is None:
                self._api.create(self._manifest())
                return True
            data = cm.get("data", {}) or {}
            holder = data.get("holder", "")
            try:
                renew = float(data.get("renew", "0"))
            except ValueError:
                renew = 0.0
            if holder != self.identity and time.time() - renew <= self.ttl_s:
                self.held_by_other = True
                return False
            fresh = self._manifest()
            fresh["metadata"] = cm.get("metadata", fresh["metadata"])
            fresh["metadata"]["name"] = self._name
            self._api.update(fresh)
            return True
        except Exception:  # noqa: BLE001 — create/update race or API flake
            logger.debug("lease acquire attempt failed", exc_info=True)
            return False

    def run(
        self,
        stop: threading.Event,
        on_started_leading: Callable[[], None],
        on_stopped_leading: Callable[[], None],
    ) -> None:
        """Blocking election loop: renew at ttl/3 while leading.

        A failed renew does NOT immediately drop leadership: the lease
        the cluster sees is still ours until ttl passes, and tearing
        every reconciler down over one flaky API call would cold-restart
        the whole namespace. Leadership is only ceded when renewal has
        failed for longer than the lease ttl (at which point a standby
        may legitimately have stolen it)."""
        leading = False
        last_renew_ok = 0.0
        while not stop.is_set():
            got = self.try_acquire()
            now = time.time()
            if got:
                last_renew_ok = now
                if not leading:
                    logger.info(
                        "leader election: %s leading", self.identity
                    )
                    leading = True
                    on_started_leading()
            elif leading and (
                self.held_by_other or now - last_renew_ok > self.ttl_s
            ):
                logger.warning(
                    "leader election: %s lost the lease (%s)",
                    self.identity,
                    "stolen by a live holder"
                    if self.held_by_other
                    else f"no successful renew for {now - last_renew_ok:.1f}s",
                )
                leading = False
                on_stopped_leading()
            stop.wait(self.ttl_s / 3 if leading else self.ttl_s / 2)
        if leading:
            on_stopped_leading()


class OperatorController:
    """Namespace-wide ElasticJob controller: one JobReconciler per job.

    The Go manager registers ElasticJob + ScalePlan controllers once and
    reconciles every object of the kind (elasticjob_controller.go:47);
    here the per-job ScalePlan/replica logic is JobReconciler, and this
    class is the fan-out: watch the collection, ensure a master
    pod + Service and a reconciler for each live job, tear down on
    DELETED.
    """

    def __init__(
        self,
        api: KubeApi,
        namespace: str = "default",
        master_port: int = MASTER_PORT,
        brain_addr: str = "",
        status_interval_s: float = 5.0,
    ):
        self._api = api
        self._ns = namespace
        self._port = master_port
        self._brain_addr = brain_addr
        self._status_interval_s = status_interval_s
        self._recs: Dict[str, JobReconciler] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._status_thread: Optional[threading.Thread] = None

    # ---- lifecycle --------------------------------------------------------

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="operator-controller", daemon=True
        )
        self._thread.start()
        self._status_thread = threading.Thread(
            target=self._status_loop, name="operator-status", daemon=True
        )
        self._status_thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._status_thread is not None:
            self._status_thread.join(timeout=5)
        for rec in self._recs.values():
            rec.stop()
        self._recs.clear()

    def jobs(self) -> List[str]:
        return sorted(self._recs)

    # ---- control loop -----------------------------------------------------

    def _adopt_current(self):
        """Sync reconcilers to the listed collection state; returns the
        rv to resume the watch from.

        The resume point is taken BEFORE the list (kube.py's hardened
        order): a job created between the two calls is then replayed by
        the watch instead of skipped forever. Runs at fresh start,
        leader failover, and post-410 relist — where reconcilers whose
        job vanished during the watch gap must be torn down here,
        because their DELETED events are gone for good."""
        list_rv = getattr(self._api, "list_rv", None)
        since = list_rv("ElasticJob", self._ns) if list_rv else 0
        listed = set()
        for obj in self._api.list("ElasticJob", self._ns):
            listed.add((obj.get("metadata") or {}).get("name", ""))
            self._ensure(obj)
        for gone in sorted(set(self._recs) - listed):
            self._teardown(gone)
        return since

    def _run(self):
        while not self._stop.is_set():
            try:
                since = self._adopt_current()
                for ev in self._api.watch(
                    kind="ElasticJob",
                    namespace=self._ns,
                    since_rv=since,
                    stop=self._stop,
                ):
                    if ev.type in ("ADDED", "MODIFIED"):
                        self._ensure(ev.obj)
                    elif ev.type == "DELETED":
                        self._teardown(
                            ev.name,
                            uid=(ev.obj.get("metadata") or {}).get(
                                "uid", ""
                            ),
                        )
                return
            except WatchExpired:
                continue  # relist via the loop head
            except Exception:
                logger.exception("operator watch failed; retrying")
                self._stop.wait(1.0)

    def _ensure(self, obj: Dict):
        name = (obj.get("metadata") or {}).get("name", "")
        if not name or name in self._recs:
            return  # per-job MODIFIED handling lives in its reconciler
        job = ElasticJob.from_manifest(obj)
        # the job-wide wire credential (common/sockets.py auth): minted
        # once into a per-job Secret so every pod of the job — across
        # operator restarts and leader failovers — authenticates the
        # checkpoint-replica / KvServer / coworker-feed planes with the
        # SAME token. Injected as a secretKeyRef (NOT a plaintext env
        # value — pods/get is granted far more broadly than
        # secrets/get, and a literal value in the pod spec would
        # defeat the Secret).
        secret_name = self._ensure_wire_token(job)
        for rs in job.spec.replica_specs.values():
            rs.secret_env.setdefault(
                "DLROVER_TPU_WIRE_TOKEN", (secret_name, "token")
            )
            rs.env.setdefault("DLROVER_TPU_RUN_ID", job.name)
        addr = self._ensure_master(job)
        rec = JobReconciler(self._api, job, master_addr=addr)
        rec.start()
        # assert desired state NOW — a real API server's watch-from-
        # current does not replay the ADDED event the way the fake does
        rec._reconcile(WatchEvent("MODIFIED", obj))
        self._recs[name] = rec
        logger.info("operator: reconciling ElasticJob %s", name)
        self._record_event(
            name,
            "Reconciling",
            "master + workers ensured",
            uid=(obj.get("metadata") or {}).get("uid", ""),
        )

    def _record_event(
        self, job_name: str, reason: str, message: str, uid: str = ""
    ):
        """Emit a k8s Event on the ElasticJob (reference: the Go
        controller's EventRecorder — `kubectl describe elasticjob`
        shows the reconcile trail). ``uid`` must be the live object's
        metadata.uid: kubectl's describe selector filters on
        involvedObject.uid, so an event without it never shows. Best-
        effort: an Event that cannot be written never blocks
        reconciliation."""
        involved = {
            "apiVersion": "elastic.iml.github.io/v1alpha1",
            "kind": "ElasticJob",
            "name": job_name,
            "namespace": self._ns,
        }
        if uid:
            involved["uid"] = uid
        try:
            self._api.create(
                {
                    "apiVersion": "v1",
                    "kind": "Event",
                    "metadata": {
                        "name": f"{job_name}.{uuid.uuid4().hex[:12]}",
                        "namespace": self._ns,
                        "labels": {JOB_LABEL: job_name},
                    },
                    "involvedObject": involved,
                    "reason": reason,
                    "message": message,
                    "type": "Normal",
                    "source": {"component": "dlrover-tpu-operator"},
                }
            )
        except Exception:  # noqa: BLE001
            logger.debug("event emit failed", exc_info=True)

    def _ensure_wire_token(self, job: ElasticJob) -> str:
        """Get-or-create the job's wire-token Secret; returns its NAME
        (pods reference it via secretKeyRef — the operator never needs
        the value back).

        Stability matters: a leader failover that minted a fresh token
        would partition new pods from old ones mid-job, so an existing
        Secret always wins. Only an AlreadyExists create race falls
        back to the re-read; any other failure (RBAC forbidden, API
        down) propagates with its real error."""
        from dlrover_tpu_torch.cluster.scaler import _is_already_exists

        name = f"{job.name}-wire-token"
        if self._api.get("Secret", name, job.namespace) is not None:
            return name
        try:
            self._api.create(
                {
                    "apiVersion": "v1",
                    "kind": "Secret",
                    "metadata": {
                        "name": name,
                        "namespace": job.namespace,
                        "labels": {JOB_LABEL: job.name},
                    },
                    "type": "Opaque",
                    "stringData": {"token": uuid.uuid4().hex},
                }
            )
        except Exception as e:  # noqa: BLE001
            if not _is_already_exists(e):
                raise  # surface the REAL error (403, timeout, ...)
        return name

    def _ensure_master(self, job: ElasticJob) -> str:
        name = f"{job.name}-master"
        if self._api.get("Pod", name, job.namespace) is None:
            self._api.create(
                master_pod_manifest(
                    job, self._port, brain_addr=self._brain_addr
                )
            )
        if self._api.get("Service", name, job.namespace) is None:
            self._api.create(master_service_manifest(job, self._port))
        return f"{name}.{job.namespace}.svc:{self._port}"

    # ---- status subresource ------------------------------------------------

    def _status_loop(self):
        """Periodic ElasticJob.status sync (reference: the Go
        controller writing ElasticJobStatus — phase + per-replica
        counts — elasticjob_controller.go updateStatus). Writes only
        when the computed status DIFFERS from the stored one, so the
        resulting MODIFIED watch events cannot feed back into a write
        loop (the reconcile they trigger is an idempotent no-op)."""
        while not self._stop.is_set():
            for name in list(self._recs):
                try:
                    self._sync_status(name)
                except Exception:  # noqa: BLE001 — keep the loop alive
                    logger.exception("status sync failed for %s", name)
            self._stop.wait(self._status_interval_s)

    def compute_status(self, name: str) -> Dict:
        """Phase + per-replica pod-phase counts for one job."""
        pods = self._api.list(
            "Pod", self._ns, label_selector={JOB_LABEL: name}
        )
        replicas: Dict[str, Dict[str, int]] = {}
        for pod in pods:
            role = (pod.get("metadata", {}).get("labels") or {}).get(
                "elasticjob.dlrover/replica-type", "worker"
            )
            phase = (pod.get("status") or {}).get("phase", "Pending")
            bucket = replicas.setdefault(role, {})
            bucket[phase] = bucket.get(phase, 0) + 1
        workers = replicas.get("worker", {})
        total = sum(workers.values())
        terminal = workers.get("Failed", 0) + workers.get("Succeeded", 0)
        if total == 0:
            phase = "Pending"
        elif workers.get("Running", 0) > 0:
            phase = "Running"
        elif terminal == total:
            # ALL workers ended: any failure makes the job Failed
            # (mixed Failed+Succeeded must not read as Pending forever)
            phase = "Failed" if workers.get("Failed", 0) else "Succeeded"
        else:
            phase = "Pending"
        return {"phase": phase, "replicaStatuses": replicas}

    def _sync_status(self, name: str):
        obj = self._api.get("ElasticJob", name, self._ns)
        if obj is None:
            return
        status = self.compute_status(name)
        if obj.get("status") == status:
            return
        # status SUBRESOURCE write: a main-resource PUT is ignored for
        # .status once the CRD enables the subresource, and a whole-
        # object write could clobber a concurrent spec change. The
        # just-fetched obj rides along so wire clients skip a re-GET.
        self._api.update_status(
            "ElasticJob", name, status, self._ns, obj=obj
        )

    def _teardown(self, name: str, uid: str = ""):
        rec = self._recs.pop(name, None)
        if rec is None:
            return
        rec.stop()
        # real k8s garbage-collects via ownerReferences; over the
        # minimal KubeApi the operator deletes the job's pods itself
        for kind in ("Pod", "ScalePlan"):
            for obj in self._api.list(
                kind, self._ns, label_selector={JOB_LABEL: name}
            ):
                self._api.delete(kind, obj["metadata"]["name"], self._ns)
        self._api.delete("Service", f"{name}-master", self._ns)
        self._api.delete("Secret", f"{name}-wire-token", self._ns)
        logger.info("operator: ElasticJob %s deleted; tore down", name)
        self._record_event(
            name,
            "TornDown",
            "pods, scale plans, service and wire-token removed",
            uid=uid,
        )


class OperatorHealthServer:
    """``/healthz`` + ``/readyz`` for the Deployment's probes
    (reference: the Go manager's health-probe bind, main.go
    ``HealthProbeBindAddress``). BOTH answer 200 while the process
    serves — readiness deliberately does NOT require leadership: a
    standby that reported 503 would deadlock rolling updates (the
    surge pod can never go Ready while the old leader renews the
    lease), which is why the Go manager serves readyz independent of
    election too. Body: JSON {leading, jobs} for operators/debugging.
    """

    def __init__(
        self,
        controller: OperatorController,
        is_leading: Callable[[], bool],
        port: int = 8081,
    ):
        self._controller = controller
        self._is_leading = is_leading
        self._requested_port = port
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self.port = 0

    def start(self):
        import http.server
        import json

        controller = self._controller
        is_leading = self._is_leading

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                leading = bool(is_leading())
                if self.path.startswith(("/healthz", "/readyz")):
                    code = 200
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = json.dumps(
                    {"leading": leading, "jobs": controller.jobs()}
                ).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence request logging
                pass

        import socketserver

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._httpd = Server(("0.0.0.0", self._requested_port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def parse_operator_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="dlrover-tpu-torch-operator")
    p.add_argument(
        "--kube-url",
        default="https://kubernetes.default.svc",
        help="API server base URL (default: in-cluster service)",
    )
    p.add_argument("--namespace", default="default")
    p.add_argument("--token", default="", help="bearer token override")
    p.add_argument(
        "--ca-path", default="", help="server CA (default: in-cluster)"
    )
    p.add_argument(
        "--no-verify", action="store_true", help="skip TLS verification"
    )
    p.add_argument("--master-port", type=int, default=MASTER_PORT)
    p.add_argument(
        "--brain-addr",
        default="",
        help="shared brain service addr, injected into masters of "
        "optimizeMode=cluster jobs (e.g. "
        "dlrover-tpu-brain.dlrover-tpu-system.svc:8600)",
    )
    p.add_argument("--lease-ttl", type=float, default=15.0)
    p.add_argument(
        "--no-leader-elect",
        action="store_true",
        help="run without the lease (single-replica deployments)",
    )
    p.add_argument(
        "--health-port",
        type=int,
        default=8081,
        help="/healthz + /readyz bind port (0 = ephemeral, -1 = off)",
    )
    return p.parse_args(argv)


def run_operator(
    args: argparse.Namespace,
    api: Optional[KubeApi] = None,
    stop: Optional[threading.Event] = None,
) -> None:
    """The entrypoint body, testable: inject ``api``/``stop``."""
    if api is None:
        from dlrover_tpu_torch.cluster.kube_http import RealKubeApi

        api = RealKubeApi(
            args.kube_url,
            token=args.token or None,
            ca_path=args.ca_path or None,
            verify=not args.no_verify,
        )
    stop = stop or threading.Event()
    controller = OperatorController(
        api,
        namespace=args.namespace,
        master_port=args.master_port,
        brain_addr=args.brain_addr,
    )
    leading = {"v": args.no_leader_elect}
    health = None
    if args.health_port >= 0:
        health = OperatorHealthServer(
            controller, lambda: leading["v"], port=args.health_port
        )
        health.start()
    try:
        if args.no_leader_elect:
            controller.start()
            try:
                stop.wait()
            finally:
                controller.stop()
            return
        elector = LeaderElector(
            api, namespace=args.namespace, ttl_s=args.lease_ttl
        )

        def _up():
            leading["v"] = True
            controller.start()

        def _down():
            leading["v"] = False
            controller.stop()

        elector.run(stop, _up, _down)
    finally:
        if health is not None:
            health.stop()


def main(argv: Optional[List[str]] = None) -> int:
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    run_operator(parse_operator_args(argv), stop=stop)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
