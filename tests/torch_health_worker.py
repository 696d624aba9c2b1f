"""One rank of the port's health-sentinel CPU checks.

Run as ``python tests/torch_health_worker.py TASK RANK WORLD PORT IN OUT``
(``torch_sp_worker.spawn(..., script=...)`` starts it): forms a gloo
group of WORLD ranks on ``tcp://127.0.0.1:PORT``, runs TASK on the spec
in IN (a ``torch.save``d dict) and writes this rank's results to OUT.
Imports torch and the port only.

Task ``sentinels``: for each case of IN (``mesh``: a ``MeshConfig``'s
fields or None for the data-parallel world; ``zero``: "zero1", "zero2"
or None; ``accum``), the JAX weights of IN (cut to this rank's shards
on a sharded mesh), ``TrainStepBuilder(health_sentinels=True)`` steps
over the global batches of IN, each rank given its rows: every step's
loss and sentinel scalars.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as shd  # noqa: E402
from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh  # noqa
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402
from dlrover_tpu_torch.train.distributed import (  # noqa: E402
    init_distributed,
    shutdown_distributed,
)
from torch_fsdp_tp_worker import data_index  # noqa: E402
from torch_zero_worker import accum_rows  # noqa: E402


def sentinels(spec, rank, world):
    out = {}
    cfg = get_config(spec["cfg"][0], **spec["cfg"][1])
    for case in spec["cases"]:
        mesh = (build_mesh(MeshConfig(**case["mesh"])) if case["mesh"]
                else None)
        tx = topt.make_optimizer(**spec["opt"])
        comm = (shd.CommConfig(update_sharding=case["zero"],
                               bucket_mb=spec["bucket_mb"])
                if case["zero"] else None)
        model = convert.load_jax_params(spec["params"], cfg, device="cpu",
                                        trainable=True, mesh=mesh)
        b = tts.TrainStepBuilder(cfg, tx, grad_accum=case["accum"],
                                 device="cpu", mesh=mesh, comm=comm,
                                 health_sentinels=True)
        assert b.update_sharding == bool(comm), b.update_sharding_reason
        opt = (tx.init({"flat": torch.zeros(
            b.plan.n_buckets, b.plan.bucket_elems // b.plan.dp)})
            if comm else tx.init(dict(model.named_parameters())))
        state = {"params": model, "opt_state": opt, "step": 0}
        index, n = data_index(mesh) if mesh is not None else (rank, world)
        steps = []
        for batch in spec["batches"]:
            state, m = b.step_fn(state, accum_rows(batch, index, n,
                                                   case["accum"]))
            steps.append({k: float(v) for k, v in m.items()
                          if k == "loss" or k.startswith("sent_")})
        out[case["id"]] = steps
    return out


def main(task, rank, world, port, path_in, path_out):
    init_distributed(coordinator=f"127.0.0.1:{port}", world_size=world,
                     rank=rank, device="cpu", timeout_s=120.0)
    try:
        spec = torch.load(path_in, weights_only=False)
        fn = {"sentinels": sentinels}[task]
        torch.save(fn(spec, rank, world), path_out)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5], sys.argv[6])
