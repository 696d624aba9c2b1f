"""Port of ``dlrover_tpu.cluster``: the Brain service and the auto-tuner
(``brain.py``). The Kubernetes binding (``crd``, ``scaler``, ``kube``,
the operator) is ROADMAP A24."""

from dlrover_tpu_torch.cluster.brain import (  # noqa: F401
    BrainClient,
    BrainService,
    BrainTuner,
    ColdStartPlanner,
    TuningPlan,
)
