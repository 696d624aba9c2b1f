"""One rank of the port's fsdp and tp CPU checks.

Run as ``python tests/torch_fsdp_tp_worker.py TASK RANK WORLD PORT IN
OUT`` (``torch_sp_worker.spawn(..., script=...)`` starts it): forms a
gloo group of WORLD ranks on ``tcp://127.0.0.1:PORT``, runs TASK on the
spec in IN (a ``torch.save``d dict) and writes this rank's results to
OUT. Imports torch and the port only.

Tasks:

- ``train``: for each case of IN, the mesh it names, the JAX weights of
  IN cut to this rank's shards (``convert.load_jax_params(mesh=)``),
  ``TrainStepBuilder`` steps over the global batches of IN, each rank
  given its rows (its dp and fsdp block of each micro-batch; the step
  keeps its sp block), through the case's ``attn_impl``; a case may
  plant a wrong reduction (``fault``: the norm scales' gradients summed
  over tp, or not over sp, or ``wk``/``wv``'s not over tp), a wrong
  move (``reshard_drop``: the backward of the q columns' move to the
  heads leaves out what it returns to another rank, the straddling
  head's other half), or run the steps through
  ``Trainer(mesh=MeshConfig(...))`` with an evaluation at the end
  (``trainer``). A case with ``zero`` ("zero1" or "zero2") runs ZeRO
  update sharding on the mesh (the hybrid step), its moments this
  rank's dp columns of the flat stream; its faults: ``unassembled``
  (``layers/mlp/w_up``'s gradient laid into the global stream from
  this rank's shard alone, not every fsdp peer's) and ``norm_world``
  (the columns' square sums added over the whole world, not dp).
  Returns the losses, grad norms (the builder's), the evaluation's loss
  (the Trainer's), and this rank's parameters and moments;
- ``trainer``: ``Trainer(mesh=MeshConfig(**IN["mesh"]))`` for
  ``steps`` steps, saving to IN's directory (memory every step, storage
  at the last), with ZeRO when IN names ``update_sharding``; then,
  unless ``restore_only``, a second ``Trainer`` that resumes from the
  staged segment and a third, the segment unlinked, from storage.
  Returns each state's leaves: every shard's global index and values.
"""

import contextlib
import os
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dlrover_tpu_torch.checkpoint.engine import (  # noqa: E402
    CheckpointEngine,
)
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models import decoder  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    MeshConfig,
    build_mesh,
)
from dlrover_tpu_torch.parallel import collectives  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as shd  # noqa: E402
from dlrover_tpu_torch.parallel.mesh import data_axes  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402
from dlrover_tpu_torch.train.distributed import (  # noqa: E402
    init_distributed,
    shutdown_distributed,
)
from torch_zero_worker import accum_rows  # noqa: E402

_NORMS = ("layers/ln1/scale", "layers/ln2/scale", "final_norm/scale")
#: the planted faults: (leaves by JAX path, axis added or dropped, axis)
FAULTS = {
    "norm_tp": (_NORMS, "add", "tp"),
    "norm_no_sp": (_NORMS, "drop", "sp"),
    "kv_no_tp": (("layers/attn/wk", "layers/attn/wv"), "drop", "tp"),
}


def data_index(mesh):
    """This rank's block of the batch axis over (dp, fsdp) jointly."""
    return (mesh.coord("dp") * mesh.shape["fsdp"] + mesh.coord("fsdp"),
            mesh.shape["dp"] * mesh.shape["fsdp"])


def plant(builder, fault):
    paths, how, axis = FAULTS[fault]
    for name, shard in builder.layout.items():
        if shard.path in paths:
            axes = set(builder.reduce_axes[name])
            if how == "add":
                axes.add(axis)
            else:
                axes.discard(axis)
            builder.reduce_axes[name] = tuple(
                a for a in tts.REDUCE_ORDER if a in axes)


@contextlib.contextmanager
def reshard_drop(model):
    """The ``reshard_drop`` fault while the block runs: the backward of
    the q columns' move to the heads (``collectives.tp_reshard``) zeroes
    the gradient it returns to another rank."""
    real = collectives._TpReshard.backward
    cols = model.tp.cols

    def backward(ctx, g):
        src, dst, group = ctx.args
        if src == cols:
            r = dist.get_rank(group)
            at = torch.arange(*dst[r])
            own = (at >= src[r][0]) & (at < src[r][1])
            g = torch.where(own, g, torch.zeros_like(g))
        return real(ctx, g)

    collectives._TpReshard.backward = staticmethod(backward)
    try:
        yield
    finally:
        collectives._TpReshard.backward = staticmethod(real)


#: the hybrid ZeRO faults' leaf
UNASSEMBLED = "layers/mlp/w_up"


def plant_zero(builder, fault):
    """A hybrid ZeRO fault (module docstring) planted in ``builder``."""
    mesh = builder.mesh
    if fault == "norm_world":
        def sums(stats, sq):
            return (builder._sum(stats, data_axes()),
                    builder._sum(sq, ("dp", "fsdp", "tp")))
        builder._zero_sums = sums
        return
    own = mesh.ranks(("fsdp", "tp")).index(mesh.rank)
    names = [n for n, sh in builder.layout.items() if sh.path == UNASSEMBLED]
    real, real_grads = shd.pack_shards, builder._grad_stream

    def own_only(cfg, peers, layouts, plan):
        peers = [p if i == own else dict(p, **{
            n: torch.zeros_like(p[n]) for n in names})
            for i, p in enumerate(peers)]
        return real(cfg, peers, layouts, plan)

    def grad_stream(params):
        shd.pack_shards = own_only
        try:
            return real_grads(params)
        finally:
            shd.pack_shards = real

    builder._grad_stream = grad_stream


def train(spec, rank, world):
    out = {}
    for case in spec["cases"]:
        name, kw = case["cfg"]
        cfg = get_config(name, **kw)
        tx = topt.make_optimizer(**spec["opt"])
        if case.get("trainer"):
            losses, norms, evals, state, shape = _trainer_run(
                spec, case, cfg, tx, rank, world)
            model = state["params"]
        else:
            mesh = build_mesh(MeshConfig(**case["mesh"]))
            shape = dict(mesh.shape)
            model = convert.load_jax_params(case["params"], cfg,
                                            device="cpu", trainable=True,
                                            mesh=mesh)
            comm = (shd.CommConfig(update_sharding=case["zero"],
                                   bucket_mb=case["bucket_mb"])
                    if case.get("zero") else None)
            b = tts.TrainStepBuilder(cfg, tx, grad_accum=case["accum"],
                                     device="cpu", mesh=mesh, comm=comm,
                                     attn_impl=case.get("attn_impl", "auto"))
            assert b.update_sharding == bool(comm), b.update_sharding_reason
            opt = (tx.init({"flat": torch.zeros(
                b.plan.n_buckets, b.plan.bucket_elems // b.plan.dp)})
                if comm else tx.init(dict(model.named_parameters())))
            state = {"params": model, "opt_state": opt, "step": 0}
            fault = contextlib.nullcontext()
            if case.get("fault") in FAULTS:
                plant(b, case["fault"])
            elif case.get("fault") == "reshard_drop":
                fault = reshard_drop(model)
            elif case.get("fault"):
                plant_zero(b, case["fault"])
            index, n = data_index(mesh)
            losses, norms, evals = [], [], []
            with fault:
                for batch in spec["batches"]:
                    state, m = b.step_fn(state, accum_rows(
                        batch, index, n, case["accum"]))
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
        opt = state["opt_state"]
        out[case["id"]] = {
            "losses": losses, "grad_norms": norms, "evals": evals,
            "params": {k: v.detach().clone()
                       for k, v in model.named_parameters()},
            "m": {k: v.clone() for k, v in opt["m"].items()},
            "v": {k: v.clone() for k, v in opt["v"].items()},
            "mesh": shape}
        if case.get("zero"):
            out[case["id"]]["shard"] = b.shard
    return out


def _trainer_run(spec, case, cfg, tx, rank, world):
    """``Trainer`` over the case's ``MeshConfig`` from the JAX weights,
    each rank given its rows, with an evaluation on ``spec["eval"]`` at
    the end: (losses, [], evals, state, mesh shape)."""
    from dlrover_tpu_torch.train.callbacks import Callback
    from dlrover_tpu_torch.train.trainer import Trainer, TrainerArgs

    mesh_cfg = MeshConfig(**case["mesh"])
    index, n = data_index(Mesh(mesh_cfg.resolved_sizes(world), rank))
    losses, evals = {}, []

    class Record(Callback):
        def on_step_end(self, trainer, step, metrics, control):
            losses[step] = float(metrics["loss"])

        def on_eval(self, trainer, step, eval_metrics, control):
            evals.append(eval_metrics["loss"])

    def init(seed):
        model = convert.load_jax_params(case["params"], cfg, device="cpu",
                                        trainable=True, mesh=t.mesh)
        return {"params": model,
                "opt_state": tx.init(dict(model.named_parameters())),
                "step": 0}

    args = TrainerArgs(output_dir=spec["output_dir"],
                       max_steps=len(spec["batches"]), save_interval=0,
                       log_interval=0, grad_accum=case["accum"],
                       detect_loss_spikes=False, report_to_master=False,
                       eval_at_end=True, eval_steps=1,
                       attn_impl=case.get("attn_impl", "auto"))
    t = Trainer(cfg, args, [accum_rows(b, index, n, case["accum"])
                            for b in spec["batches"]], tx, mesh=mesh_cfg,
                device="cpu", init_state_fn=init, callbacks=[Record()],
                eval_iter_fn=lambda: iter([accum_rows(spec["eval"], index,
                                                      n)]))
    t.train()
    # the whole-vocab logits of the trained model on this rank's rows
    logits = decoder.forward(t.state["params"], accum_rows(
        spec["eval"], index, n)["tokens"]).detach()
    return ([losses[i] for i in sorted(losses)], [], evals + [logits],
            t.state, dict(t.mesh.shape))


def _arrays(trainer):
    """{path: [(global index, this rank's values of it)]}: the state's
    leaves as the pack holds them."""
    out = {}
    for leaf in trainer.state_leaves():
        out[leaf.path] = [
            (s.index, (s.tensor.t() if s.transposed else s.tensor)
             .detach().cpu().clone()) for s in leaf.shards]
    return out


def trainer(spec, rank, world):
    from dlrover_tpu_torch.train.trainer import Trainer, TrainerArgs

    cfg = get_config(spec["cfg"][0], **spec["cfg"][1])
    mesh_cfg = MeshConfig(**spec["mesh"])
    index, n = data_index(Mesh(mesh_cfg.resolved_sizes(world), rank))

    def run(steps, resume):
        # a resumed run restores the last step and trains no further
        tx = topt.make_optimizer(**spec["opt"])
        every = 0 if resume else steps
        args = TrainerArgs(output_dir=spec["output_dir"], max_steps=steps,
                           save_interval=every,
                           memory_save_interval=min(every, 1),
                           log_interval=0, detect_loss_spikes=False,
                           report_to_master=False, resume=resume,
                           seed=spec["seed"],
                           update_sharding=spec.get("update_sharding",
                                                    False),
                           comm_bucket_mb=spec.get("bucket_mb", 4.0))
        batches = [accum_rows(b, index, n) for b in spec["batches"]]
        t = Trainer(cfg, args, batches, tx, mesh=mesh_cfg, device="cpu")
        assert t._builder.update_sharding == bool(args.update_sharding), \
            t._builder.update_sharding_reason
        t.train()
        t.checkpointer.close()
        return t

    out = {}
    if not spec.get("restore_only"):
        t = run(spec["steps"], False)
        out["saved"] = _arrays(t)
        out["mesh"] = dict(t.mesh.shape)
        # the same layout, from the staged segment, then from storage
        t = run(spec["steps"], True)
        out["memory"] = _arrays(t)
        out["memory_tier"] = t.checkpointer.engine.timings[-1]["tier"]
        CheckpointEngine.unlink_segment(rank)
    t = run(spec["steps"], True)
    out["storage"] = _arrays(t)
    out["storage_tier"] = t.checkpointer.engine.timings[-1]["tier"]
    CheckpointEngine.unlink_segment(rank)
    return out


def main(task, rank, world, port, path_in, path_out):
    init_distributed(coordinator=f"127.0.0.1:{port}", world_size=world,
                     rank=rank, device="cpu", timeout_s=120.0)
    try:
        spec = torch.load(path_in, weights_only=False)
        fn = {"train": train, "trainer": trainer}[task]
        torch.save(fn(spec, rank, world), path_out)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5], sys.argv[6])
