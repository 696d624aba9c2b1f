"""One rank of the port's sequence-parallel CPU checks.

Run as ``python tests/torch_sp_worker.py TASK RANK WORLD PORT IN OUT``:
forms a gloo group of WORLD ranks on ``tcp://127.0.0.1:PORT``, builds the
mesh named in IN (a ``torch.save``d dict), runs TASK and writes this
rank's results to OUT (``torch.save``). Imports torch and the port only.

Tasks:

- ``attention``: for each case of IN, ``ring_attention`` and
  ``ulysses_attention`` on this rank's sequence block of q, k and v,
  then the gradients of ``sum(out * cotangent)``: the block of the
  output and of each gradient;
- ``train``: for each config of IN and each ``attn_impl``, two steps of
  ``TrainStepBuilder`` over the mesh from the weights of IN, each rank
  given the rows of its dp coordinate: the losses and the state after;
- ``trainer``: ``Trainer`` with a ``MeshConfig`` for two steps and an
  evaluation at the end: the losses and the eval loss.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dlrover_tpu_torch.models import decoder  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.parallel import sequence  # noqa: E402
from dlrover_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    MeshConfig,
    build_mesh,
)
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402
from dlrover_tpu_torch.train.data_utils import (  # noqa: E402
    dp_rows,
    sequence_block,
)
from dlrover_tpu_torch.train.distributed import (  # noqa: E402
    init_distributed,
    shutdown_distributed,
)


def local_batch(batch, mesh):
    """This rank's block of a global batch: its dp rows, its sp block."""
    return sequence_block(dp_rows(batch, mesh), mesh)


def attention(spec, mesh):
    out = {}
    for name, case in spec["cases"].items():
        blk = sequence_block({k: case[k] for k in ("q", "k", "v", "ct")},
                             mesh)
        kw = dict(causal=case["causal"], window=case["window"],
                  prefix_len=case["prefix"])
        for impl in case["impls"]:
            leaves = [blk[k].contiguous().requires_grad_()
                      for k in ("q", "k", "v")]
            fn = (sequence.ring_attention if impl == "ring"
                  else sequence.ulysses_attention)
            o = fn(*leaves, mesh, **kw)
            (o * blk["ct"]).sum().backward()
            out[(name, impl)] = [o.detach()] + [x.grad for x in leaves]
    return out


def _model(cfg, state):
    model = decoder.Decoder(cfg, device="cpu", trainable=True)
    model.load_state_dict(state)
    return model


def train(spec, mesh):
    out = {}
    for name, conf in spec["configs"].items():
        cfg = get_config(conf["name"], **conf["overrides"])
        for impl in spec["impls"]:
            tx = topt.make_optimizer(**spec["opt"])
            model = _model(cfg, conf["state"])
            state = {"params": model,
                     "opt_state": tx.init(dict(model.named_parameters())),
                     "step": 0}
            step = tts.TrainStepBuilder(cfg, tx, attn_impl=impl,
                                        device="cpu", mesh=mesh).build()
            losses = []
            for batch in conf["batches"]:
                state, m = step(state, dp_rows(batch, mesh))
                losses.append(float(m["loss"]))
            out[(name, impl)] = {
                "losses": losses,
                "params": {k: v.detach().clone()
                           for k, v in model.state_dict().items()}}
    return out


def trainer(spec, _mesh):
    from dlrover_tpu_torch.train.callbacks import Callback
    from dlrover_tpu_torch.train.trainer import Trainer, TrainerArgs

    cfg = get_config("tiny", **spec["overrides"])
    tx = topt.make_optimizer(**spec["opt"])
    losses = {}

    evals = []

    class Record(Callback):
        def on_step_end(self, trainer, step, metrics, control):
            losses[step] = float(metrics["loss"])

        def on_eval(self, trainer, step, eval_metrics, control):
            evals.append(eval_metrics["loss"])

    def init(seed):
        model = _model(cfg, spec["state"])
        return {"params": model,
                "opt_state": tx.init(dict(model.named_parameters())),
                "step": 0}

    mesh_cfg = MeshConfig(**spec["mesh"])
    # the rows of this rank's dp coordinate, from the layout alone (the
    # Trainer forms the mesh's groups itself)
    layout = Mesh(mesh_cfg.resolved_sizes(spec["world"]), spec["rank"])
    args = TrainerArgs(output_dir=spec["output_dir"],
                       max_steps=len(spec["batches"]), save_interval=0,
                       log_interval=0, attn_impl=spec["attn_impl"],
                       detect_loss_spikes=False, report_to_master=False,
                       eval_at_end=True, eval_steps=1)
    t = Trainer(cfg, args, [dp_rows(b, layout) for b in spec["batches"]],
                tx, mesh=mesh_cfg, device="cpu", init_state_fn=init,
                callbacks=[Record()],
                eval_iter_fn=lambda: iter([dp_rows(spec["eval"], layout)]))
    t.train()
    return {"losses": [losses[i] for i in sorted(losses)], "evals": evals,
            "mesh": dict(t.mesh.shape)}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn(task, spec, world, tmp, timeout_s=150, script=None):
    """Run ``task`` on ``world`` ranks, each a subprocess of ``script``
    (this file by default; it takes the same arguments) under a time
    limit; returns their results by rank."""
    import subprocess

    path_in = os.path.join(str(tmp), f"{task}_in.pt")
    torch.save(spec, path_in)
    port = _free_port()
    outs = [os.path.join(str(tmp), f"{task}_out{r}.pt") for r in range(world)]
    logs = [open(os.path.join(str(tmp), f"{task}_log{r}.txt"), "w+")
            for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, script or os.path.abspath(__file__), task, str(r),
         str(world), str(port), path_in, outs[r]],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        for r in range(world)]
    try:
        rcs = [p.wait(timeout=timeout_s) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read()[-3000:])
        f.close()
    if any(rcs):
        raise RuntimeError(f"{task}: exit codes {rcs}\n" + "\n".join(texts))
    return [torch.load(o, weights_only=False) for o in outs]


def main(task, rank, world, port, path_in, path_out):
    init_distributed(coordinator=f"127.0.0.1:{port}", world_size=world,
                     rank=rank, device="cpu", timeout_s=120.0)
    try:
        spec = dict(torch.load(path_in, weights_only=False), rank=rank,
                    world=world)
        mesh = None if task == "trainer" else build_mesh(
            MeshConfig(**spec["mesh"]))
        result = {"attention": attention, "train": train,
                  "trainer": trainer}[task](spec, mesh)
        torch.save(result, path_out)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    task, rank, world, port, path_in, path_out = sys.argv[1:]
    main(task, int(rank), int(world), int(port), path_in, path_out)
