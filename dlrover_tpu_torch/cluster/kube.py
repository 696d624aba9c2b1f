"""In-process Kubernetes API double + list-watch platform binding.

Port of ``dlrover_tpu/cluster/kube.py``, with one repair (below).
Reference: the reference binds to K8s through three pieces — a list-
watch pod watcher (dlrover/python/master/watcher/k8s_watcher.py:194
``PodWatcher.watch``, resourceVersion-resumed), a pod scaler
(master/scaler/pod_scaler.py:372 ``_periodic_create_pod``), and the Go
operator's reconcile loop (go/operator/pkg/controllers/
elasticjob_controller.go:47). This module is the same contract: a
``KubeApi`` protocol the master talks to, a ``FakeKubeApi`` in-process
API-server double (thread-safe store + resourceVersion'd watch streams)
so the ENTIRE reconcile loop — pod dies → watch event → NodeEvent →
relaunch ScalePlan → new pod manifest — runs end-to-end in tests, and a
``JobReconciler`` that plays the operator for ElasticJob/ScalePlan CRDs.
A real cluster client implementing ``KubeApi``
(create/delete/list/watch) drops in unchanged.

The repair: ``JobReconciler`` applies an ElasticJob's replica count
only when the job's spec changed (the Go controller's
generation-changed predicate). The JAX reconciler re-applies it at every
ElasticJob event, and the operator's own status writes are such events:
the first status write after a ScalePlan grew the job scaled it back to
the spec's count, deleting the pod the plan had created. A plan this
reconciler has processed is not applied again when it is seen again,
even if marking it ``Succeeded`` failed.
"""

import copy
import itertools
import re
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import (
    NodeEventType,
    NodeExitReason,
    NodeStatus,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.node_manager import NodeEvent

logger = get_logger(__name__)

JOB_LABEL = "elasticjob.dlrover/name"
RANK_LABEL = "elasticjob.dlrover/rank-index"
INCARNATION_LABEL = "elasticjob.dlrover/relaunch-count"

# pod phase → node status (reference: k8s_watcher._convert_pod_event)
_PHASE_TO_STATUS = {
    "Pending": NodeStatus.PENDING,
    "Running": NodeStatus.RUNNING,
    "Succeeded": NodeStatus.SUCCEEDED,
    "Failed": NodeStatus.FAILED,
    "Unknown": NodeStatus.FAILED,
}

# container termination reason → exit reason (reference:
# pod_watcher _verify_restarting / new_pod_event classification)
_REASON_TO_EXIT = {
    "OOMKilled": NodeExitReason.OOM,
    "Evicted": NodeExitReason.KILLED,
    "Preempted": NodeExitReason.KILLED,
    "DeadlineExceeded": NodeExitReason.KILLED,
    "FatalError": NodeExitReason.FATAL_ERROR,
}


class WatchExpired(RuntimeError):
    """The watch resume point fell out of the server's history window
    (HTTP 410 Gone or an in-stream 410 ERROR event). Relist — which
    returns a fresh rv — and restart the watch from it. PodWatcher and
    JobReconciler do this inline; reference contract:
    k8s_watcher.py:219."""


@dataclass
class WatchEvent:
    type: str                 # ADDED | MODIFIED | DELETED
    obj: Dict                 # full manifest (deep copy)
    resource_version: int = 0

    @property
    def kind(self) -> str:
        return self.obj.get("kind", "")

    @property
    def name(self) -> str:
        return self.obj.get("metadata", {}).get("name", "")

    @property
    def labels(self) -> Dict[str, str]:
        return self.obj.get("metadata", {}).get("labels", {}) or {}


class KubeApi:
    """The master's platform contract (subset of a K8s client)."""

    def create(self, manifest: Dict) -> Dict:
        raise NotImplementedError

    def delete(self, kind: str, name: str, namespace: str = "default"):
        raise NotImplementedError

    def get(
        self, kind: str, name: str, namespace: str = "default"
    ) -> Optional[Dict]:
        raise NotImplementedError

    def list(
        self,
        kind: str,
        namespace: str = "default",
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Dict]:
        raise NotImplementedError

    def watch(
        self,
        kind: Optional[str] = None,
        namespace: str = "default",
        label_selector: Optional[Dict[str, str]] = None,
        since_rv: int = 0,
        stop: Optional[threading.Event] = None,
        poll_s: float = 0.2,
    ) -> Iterator[WatchEvent]:
        raise NotImplementedError

    def update_status(
        self,
        kind: str,
        name: str,
        status: Dict,
        namespace: str = "default",
        obj: Optional[Dict] = None,
    ) -> Optional[Dict]:
        """Write ONLY the status subresource (a main-resource PUT is
        ignored for .status once the CRD enables the subresource, and
        a whole-object write could clobber a concurrent spec change).
        ``obj``: optionally the already-fetched object, sparing wire
        implementations the extra GET a full-body PUT needs."""
        raise NotImplementedError


def _creation_order(obj: Dict):
    """Sort key approximating the order the watch would have delivered:
    creationTimestamp first (real servers), numeric resourceVersion as
    the tiebreaker (the fake's monotonic counter)."""
    md = obj.get("metadata", {}) or {}
    rv = str(md.get("resourceVersion", ""))
    return (
        md.get("creationTimestamp") or "",
        int(rv) if rv.isdigit() else 0,
    )


def _match_labels(obj: Dict, selector: Optional[Dict[str, str]]) -> bool:
    if not selector:
        return True
    labels = obj.get("metadata", {}).get("labels", {}) or {}
    return all(labels.get(k) == v for k, v in selector.items())


class FakeKubeApi(KubeApi):
    """API-server double: object store + resourceVersion'd watch streams.

    Everything a list-watch client observes from a real API server is
    modelled: monotonically increasing resourceVersions, replay of
    events after ``since_rv``, label-selector filtering, and phase
    transitions via ``set_pod_phase`` (the test's stand-in for the
    kubelet)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._objects: Dict[Tuple[str, str, str], Dict] = {}
        self._events: List[WatchEvent] = []
        self._rv = itertools.count(1)

    # ---- store ------------------------------------------------------------

    def _key(self, manifest: Dict) -> Tuple[str, str, str]:
        meta = manifest.get("metadata", {})
        return (
            manifest.get("kind", ""),
            meta.get("namespace", "default"),
            meta.get("name", ""),
        )

    def _emit(self, etype: str, manifest: Dict):
        rv = next(self._rv)
        manifest.setdefault("metadata", {})["resourceVersion"] = rv
        self._events.append(
            WatchEvent(etype, copy.deepcopy(manifest), rv)
        )
        self._cond.notify_all()

    def create(self, manifest: Dict) -> Dict:
        manifest = copy.deepcopy(manifest)
        with self._cond:
            key = self._key(manifest)
            if not key[2]:
                raise ValueError("manifest has no metadata.name")
            if key in self._objects:
                raise ValueError(f"{key[0]} {key[2]} already exists")
            if manifest.get("kind") == "Pod":
                manifest.setdefault("status", {"phase": "Pending"})
            self._objects[key] = manifest
            self._emit("ADDED", manifest)
        return copy.deepcopy(manifest)

    def update(self, manifest: Dict) -> Dict:
        manifest = copy.deepcopy(manifest)
        with self._cond:
            key = self._key(manifest)
            if key not in self._objects:
                raise KeyError(f"{key[0]} {key[2]} not found")
            # subresource semantics like a real server with the status
            # subresource enabled: a main-resource PUT cannot change
            # .status (the stored status, if any, is preserved) except
            # for the kubelet-standin Pod phases the tests drive
            if manifest.get("kind") != "Pod":
                old_status = self._objects[key].get("status")
                manifest.pop("status", None)
                if old_status is not None:
                    manifest["status"] = old_status
            self._objects[key] = manifest
            self._emit("MODIFIED", manifest)
        return copy.deepcopy(manifest)

    def update_status(
        self,
        kind: str,
        name: str,
        status: Dict,
        namespace: str = "default",
        obj: Optional[Dict] = None,  # unused: the store IS the truth
    ) -> Optional[Dict]:
        with self._cond:
            stored = self._objects.get((kind, namespace, name))
            if stored is None:
                return None
            stored["status"] = copy.deepcopy(status)
            self._emit("MODIFIED", stored)
            return copy.deepcopy(stored)

    def delete(self, kind: str, name: str, namespace: str = "default"):
        with self._cond:
            obj = self._objects.pop((kind, namespace, name), None)
            if obj is not None:
                self._emit("DELETED", obj)

    def get(
        self, kind: str, name: str, namespace: str = "default"
    ) -> Optional[Dict]:
        with self._cond:
            obj = self._objects.get((kind, namespace, name))
            return copy.deepcopy(obj) if obj else None

    def list(
        self,
        kind: str,
        namespace: str = "default",
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Dict]:
        with self._cond:
            return [
                copy.deepcopy(o)
                for (k, ns, _), o in sorted(self._objects.items())
                if k == kind
                and ns == namespace
                and _match_labels(o, label_selector)
            ]

    # ---- watch ------------------------------------------------------------

    def watch(
        self,
        kind: Optional[str] = None,
        namespace: str = "default",
        label_selector: Optional[Dict[str, str]] = None,
        since_rv: int = 0,
        stop: Optional[threading.Event] = None,
        poll_s: float = 0.2,
    ) -> Iterator[WatchEvent]:
        """Yield events with resource_version > since_rv (replaying the
        backlog first, like a real list-watch resuming from a listed
        resourceVersion), then block for new ones until ``stop``."""
        if isinstance(since_rv, dict):
            # per-kind resume tokens (RealKubeApi contract); the fake
            # has ONE shared rv space, so the earliest token is the
            # safe resume point (at-least-once, like a relist)
            since_rv = min(since_rv.values(), default=0)
        stop = stop or threading.Event()
        rv = since_rv
        while not stop.is_set():
            with self._cond:
                batch = [
                    ev
                    for ev in self._events
                    if ev.resource_version > rv
                    and (kind is None or ev.kind == kind)
                    and ev.obj.get("metadata", {}).get(
                        "namespace", "default"
                    )
                    == namespace
                    and _match_labels(ev.obj, label_selector)
                ]
                if not batch:
                    self._cond.wait(timeout=poll_s)
                    continue
            for ev in batch:
                rv = ev.resource_version
                yield ev

    def latest_rv(self) -> int:
        with self._cond:
            return self._events[-1].resource_version if self._events else 0

    def list_rv(self, kind: str, namespace: str = "default") -> int:
        """Collection resourceVersion (RealKubeApi parity): the rv to
        resume a watch from after a relist."""
        return self.latest_rv()

    # ---- kubelet stand-in -------------------------------------------------

    def set_pod_phase(
        self,
        name: str,
        phase: str,
        reason: str = "",
        namespace: str = "default",
    ):
        """Test hook: what the kubelet/scheduler would write to status."""
        with self._cond:
            obj = self._objects.get(("Pod", namespace, name))
            if obj is None:
                raise KeyError(f"pod {name} not found")
            obj.setdefault("status", {})["phase"] = phase
            if reason:
                obj["status"]["reason"] = reason
            self._emit("MODIFIED", obj)


# ---------------------------------------------------------------------------
# Pod list-watch → NodeEvents (reference: k8s_watcher.PodWatcher)
# ---------------------------------------------------------------------------


def pod_to_node_event(ev: WatchEvent) -> Optional[NodeEvent]:
    """Translate one pod watch event into the master's NodeEvent."""
    if ev.kind != "Pod":
        return None
    rank = ev.labels.get(RANK_LABEL)
    if rank is None:
        return None
    node_id = int(rank)
    incarnation = int(ev.labels.get(INCARNATION_LABEL, -1))
    status = ev.obj.get("status", {}) or {}
    reason = status.get("reason", "")
    exit_reason = _REASON_TO_EXIT.get(reason, "")
    if ev.type == "DELETED":
        return NodeEvent(
            NodeEventType.DELETED,
            node_id,
            status=NodeStatus.DELETED,
            exit_reason=exit_reason or NodeExitReason.KILLED,
            incarnation=incarnation,
        )
    node_status = _PHASE_TO_STATUS.get(status.get("phase", ""))
    if node_status is None:
        return None
    if node_status == NodeStatus.FAILED and not exit_reason:
        exit_reason = NodeExitReason.UNKNOWN
    return NodeEvent(
        NodeEventType.MODIFIED,
        node_id,
        status=node_status,
        exit_reason=exit_reason,
        incarnation=incarnation,
    )


class PodWatcher:
    """List-watch thread feeding a handler (JobManager.process_event).

    Reference: k8s_watcher.PodWatcher.watch (:194) — list first, then
    watch from the listed resourceVersion, surviving watch restarts."""

    def __init__(
        self,
        api: KubeApi,
        job_name: str,
        handler: Callable[[NodeEvent], None],
        namespace: str = "default",
    ):
        self._api = api
        self._job = job_name
        self._handler = handler
        self._ns = namespace
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def list_node_events(self) -> List[NodeEvent]:
        """Initial list: current pod states as synthetic MODIFIED events."""
        events = []
        for pod in self._api.list(
            "Pod", self._ns, {JOB_LABEL: self._job}
        ):
            ev = pod_to_node_event(WatchEvent("MODIFIED", pod))
            if ev:
                events.append(ev)
        return events

    def start(self, since_rv: int = 0):
        for ev in self.list_node_events():
            self._handler(ev)
        self._thread = threading.Thread(
            target=self._run,
            args=(since_rv,),
            name=f"pod-watch-{self._job}",
            daemon=True,
        )
        self._thread.start()

    def _run(self, since_rv):
        while not self._stop.is_set():
            try:
                for ev in self._api.watch(
                    kind="Pod",
                    namespace=self._ns,
                    label_selector={JOB_LABEL: self._job},
                    since_rv=since_rv,
                    stop=self._stop,
                ):
                    ne = pod_to_node_event(ev)
                    if ne is None:
                        continue
                    try:
                        self._handler(ne)
                    except Exception:
                        logger.exception(
                            "pod watch handler failed for %s", ev
                        )
                return  # watch ended via stop
            except WatchExpired as e:
                # resume-by-relist: grab a fresh collection rv FIRST,
                # then re-deliver current pod states as synthetic
                # MODIFIED events (anything that changed between the
                # two shows up again in the watch — duplicates are
                # idempotent through the stale-incarnation guard).
                # Transient API errors here must not kill the thread:
                # the 410 came from a server that may still be flaky —
                # keep the old resume point and retry the whole cycle.
                logger.info("pod watch expired (%s); relisting", e)
                try:
                    list_rv = getattr(self._api, "list_rv", None)
                    since_rv = (
                        list_rv("Pod", self._ns) if list_rv else 0
                    )
                    for ne in self.list_node_events():
                        try:
                            self._handler(ne)
                        except Exception:
                            logger.exception("relist handler failed")
                except Exception:
                    logger.exception("relist failed; retrying")
                # don't hammer an API server whose whole history window
                # is ahead of us (repeated 410s until state advances)
                self._stop.wait(0.2)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# Operator analog (reference: elasticjob_controller.go Reconcile)
# ---------------------------------------------------------------------------


class JobReconciler:
    """Reconciles ElasticJob + ScalePlan CRDs into pods via a SliceScaler.

    Reference: the Go operator's controllers
    (elasticjob_controller.go:47 — on ElasticJob events, ensure the
    replica pods exist; scaleplan_controller.go — on ScalePlan events,
    apply replicaCounts/removePods). Runs as a watch thread against any
    KubeApi; with FakeKubeApi this IS the operator for tests. An
    ElasticJob event moves the pods only when the job's spec differs
    from the one last applied (a status write is not a new desired
    state), and each ScalePlan is applied once."""

    def __init__(
        self,
        api: KubeApi,
        job,  # cluster.crd.ElasticJob
        role: str = "worker",
        master_addr: str = "",
    ):
        from dlrover_tpu_torch.cluster.scaler import SliceScaler
        from dlrover_tpu_torch.master.node_manager import ScalePlan

        self._api = api
        self._job = job
        self._role = role
        self._ns = job.namespace
        self._plan_cls = ScalePlan
        self.scaler = SliceScaler(
            job,
            role=role,
            submit_fn=api.create,
            delete_fn=lambda name: api.delete("Pod", name, self._ns),
            master_addr=master_addr,
        )
        # the ElasticJob spec last applied, and the plans applied
        self._applied_spec: Optional[Dict] = None
        self._done_plans: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, since_rv: int = 0):
        self._thread = threading.Thread(
            target=self._run,
            args=(since_rv,),
            name=f"reconcile-{self._job.name}",
            daemon=True,
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self, since_rv):
        while not self._stop.is_set():
            try:
                for ev in self._api.watch(
                    namespace=self._ns, since_rv=since_rv, stop=self._stop
                ):
                    try:
                        self._reconcile(ev)
                    except Exception:
                        logger.exception("reconcile failed for %s", ev)
                return
            except WatchExpired as e:
                # relist: re-assert the ElasticJob's DESIRED state (a
                # replica-count reconcile is idempotent) and replay any
                # ScalePlan that never reached a terminal phase —
                # processed plans are marked Succeeded via the status
                # subresource, so a stale plan can never undo scaling
                # that happened after it. Transient API errors keep the
                # old resume point and retry the cycle rather than
                # killing the operator thread.
                logger.info("reconcile watch expired (%s); relisting", e)
                try:
                    # per-kind resume tokens: rvs are opaque
                    # per-collection, so the multiplexed watch must not
                    # resume the ScalePlan pump from the ElasticJob
                    # collection's rv (or vice versa)
                    list_rv = getattr(self._api, "list_rv", None)
                    kinds = getattr(
                        self._api, "watch_kinds", ["ElasticJob"]
                    )
                    since_rv = (
                        {k: list_rv(k, self._ns) for k in kinds}
                        if list_rv
                        else 0
                    )
                    # pending plans FIRST, oldest first (list order is
                    # lexical by name — creation order is what the
                    # watch would have delivered), and the ElasticJob
                    # LAST: a spec changed during the gap is applied
                    # after them; a plan this reconciler applied before
                    # is skipped, marked or not
                    for obj in sorted(
                        self._api.list("ScalePlan", self._ns),
                        key=_creation_order,
                    ):
                        self._reconcile(WatchEvent("MODIFIED", obj))
                    for obj in self._api.list("ElasticJob", self._ns):
                        self._reconcile(WatchEvent("MODIFIED", obj))
                except Exception:
                    logger.exception("reconcile relist failed; retrying")
                self._stop.wait(0.2)

    def _reconcile(self, ev: WatchEvent):
        if ev.kind == "ElasticJob" and ev.type in ("ADDED", "MODIFIED"):
            if ev.name != self._job.name:
                return
            spec = ev.obj.get("spec", {})
            if spec == self._applied_spec:
                return  # a status or metadata write: nothing to apply
            self._applied_spec = copy.deepcopy(spec)
            if spec.get("suspend"):
                return
            replicas = (
                spec.get("replicaSpecs", {})
                .get(self._role, {})
                .get("replicas")
            )
            if replicas is None:
                return
            plan = self._plan_cls()
            plan.worker_num = replicas
            self.scaler.scale(plan)
        elif ev.kind == "ScalePlan" and ev.type in ("ADDED", "MODIFIED"):
            spec = ev.obj.get("spec", {})
            if spec.get("ownerJob") != self._job.name:
                return
            # plan lifecycle (reference: ScalePlanStatus in
            # scaleplan_types.go): a processed plan is marked
            # Succeeded via the status subresource, making it safe to
            # re-see — on replays (MODIFIED self-event, relist after a
            # 410) the terminal phase short-circuits, so an old plan
            # can never undo scaling that happened after it
            phase = (ev.obj.get("status") or {}).get("phase", "")
            if phase in ("Succeeded", "Failed") or ev.name in self._done_plans:
                return
            plan = self._plan_cls()
            counts = spec.get("replicaCounts", {})
            if self._role in counts:
                plan.worker_num = counts[self._role]
            for pod_name in spec.get("removePods", []):
                m = re.search(r"-(\d+)$", pod_name)
                if m:
                    plan.remove_nodes.append(
                        _RemoveRef(int(m.group(1)))
                    )
            if not plan.empty():
                self.scaler.scale(plan)
            self._done_plans.add(ev.name)
            self._complete_scale_plan(ev.name)

    def _complete_scale_plan(self, name: str):
        try:
            self._api.update_status(
                "ScalePlan", name, {"phase": "Succeeded"}, self._ns
            )
        except NotImplementedError:
            pass  # minimal KubeApi impls: plans stay un-marked
        except Exception:  # noqa: BLE001 — marking is best-effort;
            # this reconciler does not apply a plan twice
            logger.exception("could not mark ScalePlan %s done", name)


@dataclass
class _RemoveRef:
    """Minimal node ref for ScalePlan.remove_nodes (.id + .name)."""

    id: int = field(default=0)

    @property
    def name(self) -> str:
        return f"node-{self.id}"
