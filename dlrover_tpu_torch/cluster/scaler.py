"""Slice-aware scaler: ScalePlan → GPU-node pod creates/deletes.

Port of ``dlrover_tpu/cluster/scaler.py`` (reference: PodScaler,
master/scaler/pod_scaler.py:77 — `_periodic_create_pod`:372,
`_create_pod`:399 — and ElasticJobScaler, scaler/elasticjob_scaler.py:23,
which writes ScalePlan CRDs for the Go operator). Worker counts snap to
whole slices: a slice is ``hosts_per_slice`` GPU nodes that join and
leave as one (the JAX package's unit is a TPU slice, whose hosts share
an ICI domain; the name is kept).

The k8s API is injected as two callables (submit/delete), so the scaler is
fully testable without a cluster (the reference mocks its k8sClient the
same way, tests/test_utils.py:268).
"""

import math
import threading
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.cluster.crd import (
    ElasticJob,
    ReplicaSpec,
    ScalePlanCRD,
    pod_manifest,
)
from dlrover_tpu_torch.master.node_manager import ScalePlan, Scaler

logger = get_logger(__name__)


def _is_already_exists(exc: Exception) -> bool:
    """409/AlreadyExists from any KubeApi flavor (HTTPError carries the
    code; the in-process fake raises ValueError with the message)."""
    if getattr(exc, "code", None) == 409:
        return True
    return "already exists" in str(exc).lower()


def snap_to_slices(hosts: int, hosts_per_slice: int, minimum: int = 0) -> int:
    """Round a host count UP to whole slices (≥ minimum)."""
    if hosts_per_slice <= 1:
        return max(hosts, minimum)
    slices = math.ceil(max(hosts, minimum) / hosts_per_slice)
    return slices * hosts_per_slice


class SliceScaler(Scaler):
    """Executes master ScalePlans as slice-aligned pod creates/deletes."""

    def __init__(
        self,
        job: ElasticJob,
        role: str = "worker",
        submit_fn: Optional[Callable[[Dict], None]] = None,
        delete_fn: Optional[Callable[[str], None]] = None,
        master_addr: str = "",
    ):
        self.job = job
        self.role = role
        self.rs: ReplicaSpec = job.spec.replica_specs[role]
        hps = self.rs.slice.hosts_per_slice
        if hps > 1 and job.spec.max_hosts < hps:
            raise ValueError(
                f"max_hosts={job.spec.max_hosts} cannot fit one slice of "
                f"{hps} hosts"
            )
        self.submit_fn = submit_fn or (lambda manifest: None)
        self.delete_fn = delete_fn or (lambda name: None)
        self.master_addr = master_addr
        self._lock = threading.Lock()
        # host_index -> pod name, the scaler's view of live pods
        self._pods: Dict[int, str] = {}

    # ---- Scaler interface -------------------------------------------------

    def scale(self, plan: ScalePlan):
        with self._lock:
            if plan.worker_num is not None:
                self._scale_to(plan.worker_num)
            for node in plan.remove_nodes:
                self._remove_host(node.id)
            for node in plan.launch_nodes:
                # a relaunch keeps the node's rank index: delete the
                # predecessor pod (it may still be Running — e.g. a
                # heartbeat-timeout wedge holding its slice) and create
                # the replacement under an incarnation-suffixed name.
                # The predecessor's DELETED watch event carries the OLD
                # incarnation label, so the master's stale-event guard
                # drops it instead of relaunching again.
                idx = getattr(node, "id", None)
                attempt = getattr(node, "incarnation", 0)
                if idx is not None and idx in self._pods:
                    self._remove_host(idx)
                self._add_host(idx=idx, attempt=attempt)

    # ---- internals --------------------------------------------------------

    def _clamp_hosts(self, hosts: int) -> int:
        """Snap UP to whole slices, then clamp to max_hosts rounded DOWN
        to whole slices — rounding the cap up would exceed the operator's
        declared quota."""
        hps = self.rs.slice.hosts_per_slice
        target = snap_to_slices(
            hosts, hps, minimum=self.job.spec.min_hosts
        )
        cap = (
            (self.job.spec.max_hosts // hps) * hps
            if hps > 1
            else self.job.spec.max_hosts
        )
        return min(target, cap)

    def _scale_to(self, hosts: int):
        hps = self.rs.slice.hosts_per_slice
        target = self._clamp_hosts(hosts)
        if target != hosts:
            logger.info(
                "snapped host target %d → %d (%d hosts/slice)",
                hosts,
                target,
                hps,
            )
        # scale in: drop highest-indexed slices first (keeps rank-0 stable)
        while len(self._pods) > target:
            self._remove_host(max(self._pods))
        while len(self._pods) < target:
            self._add_host()

    def _next_index(self) -> int:
        i = 0
        while i in self._pods:
            i += 1
        return i

    def _add_host(self, idx: Optional[int] = None, attempt: int = 0):
        if idx is None:
            idx = self._next_index()
        hps = self.rs.slice.hosts_per_slice
        manifest = pod_manifest(
            self.job.name,
            self.role,
            self.rs,
            host_index=idx,
            slice_index=idx // max(hps, 1),
            master_addr=self.master_addr,
            attempt=attempt,
        )
        try:
            self.submit_fn(manifest)
            logger.info("created pod %s", manifest["metadata"]["name"])
        except Exception as e:  # noqa: BLE001
            # AlreadyExists is ADOPTION, not failure: a reconciler
            # restarted (or a failed-over operator leader) re-asserts
            # desired state over pods its predecessor created — the
            # manifest is deterministic per index, so the live pod IS
            # the one we wanted (reference: controller-runtime's
            # CreateOrUpdate idempotency)
            if not _is_already_exists(e):
                raise
            logger.info(
                "adopted existing pod %s", manifest["metadata"]["name"]
            )
        self._pods[idx] = manifest["metadata"]["name"]

    def _remove_host(self, idx: int):
        name = self._pods.pop(idx, None)
        if name is None:
            return
        self.delete_fn(name)
        logger.info("deleted pod %s", name)

    # ---- CRD mode (reference: ElasticJobScaler) ---------------------------

    def to_scale_plan_crd(self, plan: ScalePlan) -> ScalePlanCRD:
        """Render the plan as a ScalePlan CRD for an external operator
        instead of acting directly."""
        counts = {}
        if plan.worker_num is not None:
            # same clamp as the direct path: the CRD must not instruct the
            # operator to exceed max_hosts either
            counts[self.role] = self._clamp_hosts(plan.worker_num)
        return ScalePlanCRD(
            job_name=self.job.name,
            namespace=self.job.namespace,
            replica_counts=counts,
            remove_pods=[
                self._pods[n.id]
                for n in plan.remove_nodes
                if n.id in self._pods
            ],
        )

    @property
    def live_hosts(self) -> List[int]:
        return sorted(self._pods)
