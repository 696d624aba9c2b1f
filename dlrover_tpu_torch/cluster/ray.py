"""Ray platform adapter: worker lifecycle via Ray's Jobs REST API.

Port of ``dlrover_tpu/cluster/ray.py`` (reference:
dlrover/python/scheduler/ray.py, RayScheduler, and
client/platform/ray/ray_job_submitter.py:48 — the reference drives Ray
actors through the ray SDK). The master's platform
contract is the SliceScaler's (submit_fn, delete_fn) pair plus a
list for reconciliation, and Ray's dashboard exposes exactly that as a
plain REST surface (/api/jobs/ — submit, stop, list, status) — so the
adapter binds with stdlib HTTP, no ray SDK import (the SDK is not in
the image; the REST API is versioned and what `ray job submit` itself
speaks).

Each worker "pod" manifest from the SliceScaler becomes one Ray job:
the entrypoint runs the port's launcher with the same env the k8s pod
would get (master address, node rank and id, run id); the manifest's
``metadata.name`` doubles as the Ray submission_id so deletes and
list-reconciliation address jobs by the scaler's names.
"""

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


class RayJobsApi:
    """Thin client for Ray's Jobs REST API (dashboard, default :8265)."""

    def __init__(self, address: str, timeout_s: float = 30.0):
        # address: "http://host:8265"
        self.base = address.rstrip("/")
        self.timeout_s = timeout_s

    def _request(self, method: str, path: str, body: Optional[Dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base + path, data=data, method=method
        )
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(  # noqa: S310
            req, timeout=self.timeout_s
        ) as resp:
            raw = resp.read()
        return json.loads(raw) if raw else {}

    def submit(
        self,
        submission_id: str,
        entrypoint: str,
        env: Optional[Dict[str, str]] = None,
        resources: Optional[Dict[str, float]] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        body = {
            "submission_id": submission_id,
            "entrypoint": entrypoint,
            "runtime_env": {"env_vars": env or {}},
            "metadata": metadata or {},
        }
        if resources:
            body["entrypoint_resources"] = resources
        out = self._request("POST", "/api/jobs/", body)
        return out.get("submission_id", submission_id)

    def stop(self, submission_id: str) -> bool:
        try:
            out = self._request(
                "POST", f"/api/jobs/{submission_id}/stop", {}
            )
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise
        return bool(out.get("stopped", True))

    def delete(self, submission_id: str):
        """Stop + forget: Ray keeps terminal jobs listed; DELETE removes
        the record once stopped (best-effort on both calls)."""
        self.stop(submission_id)
        try:
            self._request("DELETE", f"/api/jobs/{submission_id}")
        except urllib.error.HTTPError as e:
            if e.code not in (404, 500):
                raise

    def status(self, submission_id: str) -> Optional[str]:
        try:
            out = self._request("GET", f"/api/jobs/{submission_id}")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise
        return out.get("status")

    def list(self) -> List[Dict]:
        return self._request("GET", "/api/jobs/")


class RayJobSubmitter:
    """SliceScaler binding: manifests in, Ray jobs out.

    Usage (mirrors the FakeKubeApi/RealKubeApi wiring in tests):

        api = RayJobsApi("http://head:8265")
        sub = RayJobSubmitter(api, master_addr="10.0.0.1:8000")
        scaler = SliceScaler(job, submit_fn=sub.submit, delete_fn=sub.delete)
    """

    def __init__(
        self,
        api: RayJobsApi,
        master_addr: str = "",
        worker_cmd: str = "python -m dlrover_tpu_torch.agent.launcher",
        resources: Optional[Dict[str, float]] = None,
        run_id: str = "",
    ):
        self.api = api
        self.master_addr = master_addr
        self.worker_cmd = worker_cmd
        self.resources = resources
        self.run_id = run_id

    def submit(self, manifest: Dict) -> Dict:
        """Accepts the SliceScaler's pod manifest; launches a Ray job."""
        meta = manifest.get("metadata", {})
        name = meta["name"]
        labels = meta.get("labels", {}) or {}
        env = {}
        for c in (
            manifest.get("spec", {}).get("containers", []) or []
        ):
            for kv in c.get("env", []) or []:
                if "name" in kv and "value" in kv:
                    env[kv["name"]] = str(kv["value"])
        env.setdefault("DLROVER_MASTER_ADDR", self.master_addr)
        if self.run_id:
            env.setdefault("DLROVER_TPU_RUN_ID", self.run_id)
        self.api.submit(
            submission_id=name,
            entrypoint=self.worker_cmd,
            env=env,
            resources=self.resources,
            metadata={str(k): str(v) for k, v in labels.items()},
        )
        logger.info("ray job submitted: %s", name)
        return manifest

    def delete(self, name: str):
        self.api.delete(name)
        logger.info("ray job deleted: %s", name)

    def live_jobs(self) -> List[str]:
        """Names of non-terminal jobs — the scaler's reconcile input."""
        out = []
        for job in self.api.list():
            sid = job.get("submission_id") or job.get("job_id")
            if sid and job.get("status") in (
                "PENDING", "RUNNING",
            ):
                out.append(sid)
        return out
