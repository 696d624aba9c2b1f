"""Port of ``dlrover_tpu.cluster``: the Brain service and the auto-tuner
(``brain.py``), and the cluster binding: the ElasticJob and ScalePlan
CRDs for GPU nodes (``crd.py``), the slice scaler (``scaler.py``), the
API double, pod watcher and reconciler (``kube.py``), the HTTP client
(``kube_http.py``), the operator (``operator.py``) and the Ray Jobs
adapter (``ray.py``). Importing the package loads neither ``yaml`` nor
the HTTP client."""

from dlrover_tpu_torch.cluster.brain import (  # noqa: F401
    BrainClient,
    BrainService,
    BrainTuner,
    ColdStartPlanner,
    TuningPlan,
)
from dlrover_tpu_torch.cluster.crd import (  # noqa: F401
    ElasticJob,
    ElasticJobSpec,
    GPUSliceSpec,
    ReplicaSpec,
    ScalePlanCRD,
)
from dlrover_tpu_torch.cluster.scaler import SliceScaler  # noqa: F401
