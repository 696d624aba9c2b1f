"""ElasticJob / ScalePlan CRD shapes for GPU nodes.

Port of ``dlrover_tpu/cluster/crd.py`` (reference:
dlrover/go/operator/api/v1alpha1/elasticjob_types.go:29,108 and
scaleplan_types.go:29 — the two CRDs the Go operator reconciles). The
manifests keep the JAX package's layout (group/version/kind, replica
specs, scale spec) but for the node a pod asks for: the JAX package's
``TPUSliceSpec`` pins a TPU pod slice through the GKE TPU node selectors
and requests ``google.com/tpu`` chips; the port's ``GPUSliceSpec`` pins
a GPU product through ``nvidia.com/gpu.product`` (the label NVIDIA's GPU
feature discovery puts on a node) and requests ``nvidia.com/gpu``. A
"slice" is ``hosts_per_slice`` GPU nodes that scale as one unit (the
example's ``--hosts-per-slice`` layout), one node by default.

Every pod also carries ``DLROVER_TPU_NODE_ID`` = its host index: the
launcher takes its node id from that variable, and a pod template,
shared by every replica, cannot carry a ``--node-id`` of its own (the
JAX manifest sets only ``DLROVER_TPU_NODE_RANK``, so every pod of a JAX
job registers as node 0).

``render_yaml`` writes the manifest as indented JSON, which is YAML: the
port does not import ``yaml``.
"""

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

GROUP = "elastic.iml.github.io"
VERSION = "v1alpha1"

GPU_RESOURCE = "nvidia.com/gpu"
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"


@dataclass
class GPUSliceSpec:
    """One node flavor: the GPU product and the GPUs a node gives a pod;
    ``hosts_per_slice`` nodes scale together."""

    gpu_product: str = "NVIDIA-H100-80GB-HBM3"  # nvidia.com/gpu.product
    gpus_per_host: int = 8
    hosts_per_slice: int = 1

    @property
    def gpus_per_slice(self) -> int:
        return self.gpus_per_host * self.hosts_per_slice


@dataclass
class ReplicaSpec:
    """Reference: ReplicaSpec in elasticjob_types.go (replicas + template)."""

    replicas: int = 1                     # in HOSTS
    image: str = "dlrover-tpu:latest"
    command: List[str] = field(default_factory=list)
    cpu: str = "8"
    memory: str = "32Gi"
    env: Dict[str, str] = field(default_factory=dict)
    # env var -> (secret name, key): rendered as valueFrom.secretKeyRef
    # so credentials (the wire token) never appear as plaintext in pod
    # specs readable by anyone with pods/get
    secret_env: Dict[str, Any] = field(default_factory=dict)
    slice: GPUSliceSpec = field(default_factory=GPUSliceSpec)


@dataclass
class ElasticJobSpec:
    distribution_strategy: str = "AllreduceStrategy"
    optimize_mode: str = "single-job"    # single-job | cluster (brain)
    replica_specs: Dict[str, ReplicaSpec] = field(default_factory=dict)
    min_hosts: int = 1
    max_hosts: int = 1
    suspend: bool = False


@dataclass
class ElasticJob:
    name: str
    namespace: str = "default"
    spec: ElasticJobSpec = field(default_factory=ElasticJobSpec)
    labels: Dict[str, str] = field(default_factory=dict)

    def to_manifest(self) -> Dict[str, Any]:
        return {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": "ElasticJob",
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "labels": dict(self.labels),
            },
            "spec": {
                "distributionStrategy": self.spec.distribution_strategy,
                "optimizeMode": self.spec.optimize_mode,
                "minHosts": self.spec.min_hosts,
                "maxHosts": self.spec.max_hosts,
                "suspend": self.spec.suspend,
                "replicaSpecs": {
                    role: {
                        "replicas": rs.replicas,
                        "hostsPerSlice": rs.slice.hosts_per_slice,
                        "template": pod_template(self.name, role, rs),
                    }
                    for role, rs in self.spec.replica_specs.items()
                },
            },
        }

    def render_yaml(self) -> str:
        return render_yaml(self.to_manifest())

    @staticmethod
    def from_manifest(obj: Dict[str, Any]) -> "ElasticJob":
        """Rebuild the job object from a watched/applied manifest — the
        operator's inverse of ``to_manifest``."""
        meta = obj.get("metadata", {}) or {}
        spec = obj.get("spec", {}) or {}
        replica_specs: Dict[str, ReplicaSpec] = {}
        for role, rs in (spec.get("replicaSpecs") or {}).items():
            tpl = (rs.get("template") or {}).get("spec", {}) or {}
            cont = (tpl.get("containers") or [{}])[0]
            sel = tpl.get("nodeSelector", {}) or {}
            req = (cont.get("resources") or {}).get("requests", {}) or {}
            env: Dict[str, str] = {}
            secret_env: Dict[str, Any] = {}
            for e in cont.get("env") or []:
                if "name" not in e:
                    continue
                ref = (e.get("valueFrom") or {}).get("secretKeyRef")
                if ref:
                    secret_env[e["name"]] = (
                        ref.get("name", ""),
                        ref.get("key", ""),
                    )
                else:
                    env[e["name"]] = e.get("value", "")
            default = GPUSliceSpec()
            replica_specs[role] = ReplicaSpec(
                replicas=int(rs.get("replicas", 1)),
                image=cont.get("image", "dlrover-tpu:latest"),
                command=list(cont.get("command") or []),
                cpu=str(req.get("cpu", "8")),
                memory=str(req.get("memory", "32Gi")),
                env=env,
                secret_env=secret_env,
                slice=GPUSliceSpec(
                    gpu_product=sel.get(GPU_PRODUCT_LABEL,
                                        default.gpu_product),
                    gpus_per_host=int(req.get(GPU_RESOURCE,
                                              default.gpus_per_host)),
                    hosts_per_slice=int(rs.get("hostsPerSlice", 1)),
                ),
            )
        return ElasticJob(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            labels=dict(meta.get("labels") or {}),
            spec=ElasticJobSpec(
                distribution_strategy=spec.get(
                    "distributionStrategy", "AllreduceStrategy"
                ),
                optimize_mode=spec.get("optimizeMode", "single-job"),
                replica_specs=replica_specs,
                min_hosts=int(spec.get("minHosts", 1)),
                max_hosts=int(spec.get("maxHosts", 1)),
                suspend=bool(spec.get("suspend", False)),
            ),
        )


@dataclass
class ScalePlanCRD:
    """Reference: ScalePlanSpec (scaleplan_types.go:29) — desired replica
    counts plus explicit create/remove pod lists, owned by a job."""

    job_name: str
    name: str = ""
    namespace: str = "default"
    replica_counts: Dict[str, int] = field(default_factory=dict)  # hosts
    create_pods: List[Dict] = field(default_factory=list)
    remove_pods: List[str] = field(default_factory=list)
    manual_scaling: bool = False

    def to_manifest(self) -> Dict[str, Any]:
        return {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": "ScalePlan",
            "metadata": {
                "name": self.name or f"{self.job_name}-scaleplan",
                "namespace": self.namespace,
                "labels": {"elasticjob.dlrover/name": self.job_name},
            },
            "spec": {
                "ownerJob": self.job_name,
                "replicaCounts": dict(self.replica_counts),
                "createPods": list(self.create_pods),
                "removePods": list(self.remove_pods),
                "manualScaling": self.manual_scaling,
            },
        }

    def render_yaml(self) -> str:
        return render_yaml(self.to_manifest())


def render_yaml(manifest: Dict[str, Any]) -> str:
    """A manifest as YAML for ``kubectl apply -f``: indented JSON, which
    every YAML 1.2 parser reads (keys in the manifest's order)."""
    return json.dumps(manifest, indent=2) + "\n"


def pod_template(
    job_name: str, role: str, rs: ReplicaSpec
) -> Dict[str, Any]:
    """Pod template for one GPU node of a slice."""
    sl = rs.slice
    return {
        "metadata": {
            "labels": {
                "elasticjob.dlrover/name": job_name,
                "elasticjob.dlrover/replica-type": role,
            },
        },
        "spec": {
            "restartPolicy": "Never",
            "nodeSelector": {GPU_PRODUCT_LABEL: sl.gpu_product},
            "containers": [
                {
                    "name": "main",
                    "image": rs.image,
                    "command": list(rs.command),
                    "env": [
                        {"name": k, "value": v} for k, v in rs.env.items()
                    ]
                    + [
                        {
                            "name": k,
                            "valueFrom": {
                                "secretKeyRef": {
                                    "name": ref[0],
                                    "key": ref[1],
                                }
                            },
                        }
                        for k, ref in rs.secret_env.items()
                    ],
                    "resources": {
                        "requests": {
                            "cpu": rs.cpu,
                            "memory": rs.memory,
                            GPU_RESOURCE: str(sl.gpus_per_host),
                        },
                        "limits": {GPU_RESOURCE: str(sl.gpus_per_host)},
                    },
                }
            ],
        },
    }


def pod_manifest(
    job_name: str,
    role: str,
    rs: ReplicaSpec,
    host_index: int,
    slice_index: int,
    master_addr: str = "",
    attempt: int = 0,
) -> Dict[str, Any]:
    """Concrete pod for host ``host_index`` (global), slice-annotated so
    the master's rendezvous can group a slice's nodes. ``attempt`` > 0
    suffixes the name so a relaunched pod never collides with its dead
    predecessor still visible in the API; the relaunched pod keeps the
    host index, and with it its node id."""
    tpl = pod_template(job_name, role, rs)
    name = f"{job_name}-{role}-{host_index}"
    if attempt:
        name = f"{name}-r{attempt}"
    tpl["metadata"]["name"] = name
    tpl["metadata"]["labels"].update(
        {
            "elasticjob.dlrover/rank-index": str(host_index),
            "elasticjob.dlrover/slice-index": str(slice_index),
            "elasticjob.dlrover/relaunch-count": str(attempt),
        }
    )
    env = tpl["spec"]["containers"][0]["env"]
    env.extend(
        [
            {"name": "DLROVER_TPU_NODE_RANK", "value": str(host_index)},
            {"name": "DLROVER_TPU_NODE_ID", "value": str(host_index)},
            {"name": "DLROVER_TPU_SLICE_INDEX", "value": str(slice_index)},
            {
                "name": "DLROVER_TPU_HOSTS_PER_SLICE",
                "value": str(rs.slice.hosts_per_slice),
            },
        ]
    )
    if master_addr:
        env.append(
            {"name": "DLROVER_TPU_MASTER_ADDR", "value": master_addr}
        )
    return {"apiVersion": "v1", "kind": "Pod", **tpl}
