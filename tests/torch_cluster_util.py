"""Shared by the cluster-binding parity tests (``test_torch_kube.py``,
``test_torch_operator.py``, ``test_torch_kube_http.py``,
``test_torch_ray.py``): each package's cluster modules behind one
namespace, so a scenario runs unchanged against the JAX package and the
port, and the normal form their pods are compared in.

The manifests differ only where the port names a GPU node: the node
selector (``nvidia.com/gpu.product`` for the GKE TPU keys), the device
resource (``nvidia.com/gpu`` for ``google.com/tpu``) and the port's
``DLROVER_TPU_NODE_ID`` variable. ``normal_pod`` drops exactly those.
"""

import copy
import time
from types import SimpleNamespace

TPU_KEYS = ("cloud.google.com/gke-tpu-accelerator",
            "cloud.google.com/gke-tpu-topology", "google.com/tpu")
GPU_KEYS = ("nvidia.com/gpu.product", "nvidia.com/gpu")
PORT_ONLY_ENV = ("DLROVER_TPU_NODE_ID",)


def packages():
    """{"jax": ..., "torch": ...}: each package's cluster modules and
    node manager, and its node spec class (``slice_cls``)."""
    import dlrover_tpu.cluster.crd as jcrd
    import dlrover_tpu.cluster.kube as jkube
    import dlrover_tpu.cluster.kube_http as jhttp
    import dlrover_tpu.cluster.operator as jop
    import dlrover_tpu.cluster.ray as jray
    import dlrover_tpu.cluster.scaler as jscaler
    import dlrover_tpu.common.constants as jconst
    import dlrover_tpu.common.node as jnode
    import dlrover_tpu.master.node_manager as jnm
    from dlrover_tpu_torch.cluster import crd, kube, kube_http, operator
    from dlrover_tpu_torch.cluster import ray, scaler
    from dlrover_tpu_torch.common import constants, node
    from dlrover_tpu_torch.master import node_manager

    return {
        "jax": SimpleNamespace(
            name="jax", crd=jcrd, kube=jkube, http=jhttp, operator=jop,
            ray=jray, scaler=jscaler, const=jconst, node=jnode, nm=jnm,
            slice_cls=jcrd.TPUSliceSpec),
        "torch": SimpleNamespace(
            name="torch", crd=crd, kube=kube, http=kube_http,
            operator=operator, ray=ray, scaler=scaler, const=constants,
            node=node, nm=node_manager, slice_cls=crd.GPUSliceSpec),
    }


def demo_job(pkg, name="demo", replicas=2, max_hosts=4, hosts_per_slice=1,
             min_hosts=1, **rs_kw):
    return pkg.crd.ElasticJob(
        name,
        spec=pkg.crd.ElasticJobSpec(
            replica_specs={"worker": pkg.crd.ReplicaSpec(
                replicas=replicas,
                slice=pkg.slice_cls(hosts_per_slice=hosts_per_slice),
                **rs_kw)},
            min_hosts=min_hosts,
            max_hosts=max_hosts,
        ),
    )


def normal_pod(pod):
    """A pod manifest without the keys the packages name differently:
    status, resourceVersion and the GPU/TPU keys and env."""
    pod = copy.deepcopy(pod)
    pod.get("metadata", {}).pop("resourceVersion", None)
    spec = pod.get("spec", {})
    for key in TPU_KEYS + GPU_KEYS:
        spec.get("nodeSelector", {}).pop(key, None)
        for cont in spec.get("containers", []):
            for part in cont.get("resources", {}).values():
                part.pop(key, None)
    for cont in spec.get("containers", []):
        cont["env"] = [e for e in cont.get("env", [])
                       if e.get("name") not in PORT_ONLY_ENV]
    return pod


def added_pods(api):
    """The names of the Pods the store created, in creation order."""
    return [ev.name for ev in api._events
            if ev.type == "ADDED" and ev.kind == "Pod"]


def wait(cond, timeout=8.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


_CHIP_SMOKE = []


def chip_smoke():
    """``chip_smoke.py`` as a module (its ``KubeFacade``: the port's API
    server double over HTTP), loaded once."""
    if not _CHIP_SMOKE:
        import importlib.util
        import os

        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py")
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _CHIP_SMOKE.append(mod)
    return _CHIP_SMOKE[0]
