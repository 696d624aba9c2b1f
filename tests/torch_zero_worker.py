"""One rank of the port's ZeRO, data-shard and live-reshard CPU checks.

Run as ``python tests/torch_zero_worker.py TASK RANK WORLD PORT IN OUT``
(``torch_sp_worker.spawn(..., script=...)`` starts it): forms a gloo
group of WORLD ranks on ``tcp://127.0.0.1:PORT``, runs TASK on the spec
in IN (a ``torch.save``d dict) and writes this rank's results to OUT.
Imports torch and the port only.

Tasks:

- ``zero``: for each case ``(mode, grad_accum)`` of IN (mode "zero1",
  "zero2" or None for the replicated step), steps of
  ``TrainStepBuilder`` from the weights of IN over the global batches of
  IN, each rank given its rows (``accum_rows``): the losses,
  grad norms, parameters and this rank's moments;
- ``exchange``: for each case of IN (a wire, a plan, every rank's
  packed stream and tied-head extra), ``exchange_buckets`` of this
  rank's stream over the world: this rank's columns and the bytes it
  counted on the wire;
- ``shards``: ``iter_shards_spmd`` over a ``ShardingClient`` of the
  master at IN's address: the shard sequence this rank saw;
- ``reshard``: the ``LiveResharder`` fault cases on synthetic plans,
  then a zero2 run at dp 4, the eviction of ranks 2 and 3 (the flat
  state migrated onto a dp 2 group), and the continuation at
  ``grad_accum`` 2 from the migrated state and from the canonical
  ``reshard_flat`` repack of the gathered state.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa: E402
from dlrover_tpu_torch.agent.sharding_client import (  # noqa: E402
    ShardingClient,
)
from dlrover_tpu_torch.elastic import faults  # noqa: E402
from dlrover_tpu_torch.elastic.resharding import (  # noqa: E402
    LiveResharder,
    PhaseBudgets,
    migrate_flat,
    reshard_flat,
    reshard_train_state,
)
from dlrover_tpu_torch.elastic.trainer import ElasticTrainer  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.observability import telemetry  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as shd  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402
from dlrover_tpu_torch.train.data_utils import iter_shards_spmd  # noqa
from dlrover_tpu_torch.train.distributed import (  # noqa: E402
    init_distributed,
    shutdown_distributed,
)


def accum_rows(batch, index: int, n: int, grad_accum: int = 1):
    """Rank ``index`` of ``n``'s rows of a global batch for a step of
    ``grad_accum`` micro-batches, as the JAX step lays them out:
    micro-batch i is global rows [i·B/a, (i+1)·B/a), of which each rank
    takes its block; this rank's blocks come back micro-batch after
    micro-batch (the train step cuts them apart again)."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        micro = v.reshape((grad_accum, v.shape[0] // grad_accum)
                          + tuple(v.shape[1:]))
        size = micro.shape[1] // n
        out[k] = micro[:, index * size:(index + 1) * size].reshape(
            (-1,) + tuple(v.shape[1:]))
    return out


def synth_plan(dp, n_buckets, bucket_elems, total, mesh_axes=("dp",)):
    return shd.PackPlan(shapes=(), sizes=(), offsets=(), total=total,
                        bucket_elems=bucket_elems, n_buckets=n_buckets,
                        dp=dp, tie_size=0, n_tie_buckets=0,
                        mesh_axes=mesh_axes)


def canonical_fill(plan, seed=0):
    """A flat (nb, E) leaf: a random canonical stream, zero padding."""
    rng = np.random.RandomState(seed)
    out = np.zeros(plan.padded, np.float32)
    out[: plan.total] = rng.randn(plan.total).astype(np.float32)
    return torch.from_numpy(out.reshape(plan.n_buckets, plan.bucket_elems))


def _state(spec, comm=None, group=None):
    cfg = get_config(spec["cfg"][0], **spec["cfg"][1])
    opt = topt.make_optimizer(**spec["opt"])
    state = tts.init_train_state(0, cfg, opt, device="cpu", comm=comm,
                                 group=group)
    state["params"].load_state_dict(spec["weights"])
    return cfg, opt, state


def _out(state, builder):
    opt = state["opt_state"]
    return {"params": {n: p.detach().clone()
                       for n, p in state["params"].named_parameters()},
            "m": {k: t.clone() for k, t in opt["m"].items()},
            "v": {k: t.clone() for k, t in opt["v"].items()},
            "count": opt["step"], "step": state["step"],
            "plan": builder.plan}


def zero(spec, rank, world):
    out = {}
    for mode, accum in spec["cases"]:
        comm = (shd.CommConfig(update_sharding=mode,
                               bucket_mb=spec["bucket_mb"]) if mode else None)
        cfg, opt, state = _state(spec, comm)
        b = tts.TrainStepBuilder(cfg, opt, grad_accum=accum, device="cpu",
                                 comm=comm)
        assert b.update_sharding == bool(mode), b.update_sharding_reason
        losses, norms = [], []
        for batch in spec["batches"]:
            state, m = b.step_fn(state, accum_rows(batch, rank, world,
                                                   accum))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[(mode, accum)] = dict(_out(state, b), losses=losses,
                                  grad_norms=norms)
    return out


def exchange(spec, rank, world):
    out = {}
    for cid, case in spec["cases"].items():
        extra = case["tie_extra"]
        before = shd.WIRE["bytes"]
        got = shd.exchange_buckets(
            case["streams"][rank], case["plan"], wire=case["wire"],
            tie_extra=None if extra is None else extra[rank])
        out[cid] = {"shard": got, "bytes": shd.WIRE["bytes"] - before}
    return out


def shards(spec, rank, world):
    client = MasterClient(spec["addr"], node_id=rank)
    sc = ShardingClient(client, spec["name"], spec["size"], spec["shard"])
    seen = []
    for start, end in iter_shards_spmd(sc, poll_interval_s=0.05):
        seen.append((start, end))
        if rank == 0:
            assert sc.report_shard_done() == (start, end)
    return {"seen": seen}


def _events():
    telemetry.reset_hub()
    events = []
    telemetry.configure_hub().subscribe(events.append)
    return events


def fault_cases(rank):
    """Each LiveResharder case on synthetic plans over dp 4 → 2."""
    old, new = synth_plan(4, 3, 32, 90), synth_plan(2, 2, 48, 90)
    full = canonical_fill(old, seed=3)
    mine = {"f": full[:, old.columns(rank)].contiguous()}
    want = (reshard_flat(full, old, new)[:, new.columns(rank)]
            if rank < 2 else None)
    ranks = dict(old_ranks=[0, 1, 2, 3], new_ranks=[0, 1])
    out = {}

    def run(name, inj=None, dead=(), budgets=None, retries=2, plans=None):
        events = _events()
        calls = []

        def migrate(_):
            calls.append(1)
            if plans is not None:
                return reshard_train_state(
                    {"opt_state": {"m": {"flat": mine["f"]},
                                   "v": {"flat": mine["f"]}}},
                    *plans, faults=inj, **ranks)
            return migrate_flat(mine, old, new, faults=inj, dead_ranks=dead,
                                **ranks)

        rs = LiveResharder(budgets=budgets, faults=inj, retries=retries,
                           backoff_base_s=0.01)
        o = rs.execute([("replan", lambda _: None), ("migrate", migrate)],
                       fallback=lambda e: ("fallback", type(e).__name__))
        res = o.result
        if o.path == "live":
            res = (res is None if want is None
                   else bool(torch.equal(res["f"], want)))
        out[name] = {"path": o.path, "result": res, "reason": o.reason,
                     "failed_phase": o.failed_phase, "calls": len(calls),
                     "events": [(e.kind, e.detail) for e in events]}

    run("live")
    inj = faults.FaultInjector()
    inj.install(faults.FaultSpec("torn_donation", point="donation", times=1))
    run("transient", inj)
    inj = faults.FaultInjector()
    inj.install(faults.FaultSpec("torn_donation", point="donation"))
    run("persistent", inj)
    run("dead_donor", dead=(3,))
    inj = faults.FaultInjector()
    inj.install(faults.FaultSpec("slow_peer", point="donation", delay_s=0.3,
                                 times=1))
    run("deadline", inj, budgets=PhaseBudgets(migrate_s=0.05), retries=0)
    hybrid = synth_plan(4, 3, 32, 90, mesh_axes=("dp", "fsdp"))
    run("hybrid", plans=(hybrid, new))
    telemetry.reset_hub()
    return out


def reshard(spec, rank, world):
    out = {"faults": fault_cases(rank)}
    comm = shd.CommConfig(update_sharding=True, bucket_mb=spec["bucket_mb"])
    cfg, opt, state = _state(spec, comm)
    b4 = tts.TrainStepBuilder(cfg, opt, device="cpu", comm=comm)
    pre = []
    for batch in spec["pre"]:
        state, m = b4.step_fn(state, accum_rows(batch, rank, world))
        pre.append(float(m["loss"]))
    out["pre"] = pre
    old = b4.plan
    full = {k: shd.all_gather_columns(state["opt_state"][k]["flat"], old)
            for k in ("m", "v")}
    params = dict(state["params"].named_parameters())
    full["params"] = shd.pack_flat(cfg, params, old)
    group = dist.new_group([0, 1])
    new = shd.build_pack_plan(cfg, params, 2, comm.bucket_bytes)
    live = reshard_train_state(state, old, new, [0, 1, 2, 3], [0, 1])
    if rank >= 2:
        out["live"] = live
        return out
    cols = new.columns(rank)
    repack = {k: reshard_flat(full[k], old, new)[:, cols] for k in full}
    out["migrated_equal"] = {
        "m": torch.equal(live["opt_state"]["m"]["flat"], repack["m"]),
        "v": torch.equal(live["opt_state"]["v"]["flat"], repack["v"]),
        "params": torch.equal(shd.pack_flat(cfg, params, new)[:, cols],
                              repack["params"])}
    _, _, canon = _state(spec, comm, group)
    canon["params"].load_state_dict(state["params"].state_dict())
    canon["opt_state"] = dict(state["opt_state"],
                              m={"flat": repack["m"].clone()},
                              v={"flat": repack["v"].clone()})
    canon["step"] = state["step"]
    replicas = [4]
    builders = []

    def build(accum):
        b = tts.TrainStepBuilder(cfg, opt, grad_accum=accum, device="cpu",
                                 comm=comm, group=group if replicas[0] == 2
                                 else None)
        builders.append(b)
        return b.build()

    et = ElasticTrainer(spec["global_batch"], spec["global_batch"] // 4,
                        build, data_replicas_fn=lambda: replicas[0])
    accums = [et.grad_accum]
    replicas[0] = 2
    et.on_membership_change()
    accums.append(et.grad_accum)
    out["accums"] = accums
    runs = {}
    for name, st in (("live", live), ("canonical", canon)):
        losses = []
        for batch in spec["post"]:
            st, m = et.step(st, accum_rows(batch, rank, 2, et.grad_accum))
            losses.append(float(m["loss"]))
        runs[name] = dict(_out(st, builders[-1]), losses=losses)
    out["runs"] = runs
    return out


def main(task, rank, world, port, path_in, path_out):
    init_distributed(coordinator=f"127.0.0.1:{port}", world_size=world,
                     rank=rank, device="cpu", timeout_s=120.0)
    try:
        spec = torch.load(path_in, weights_only=False)
        fn = {"zero": zero, "shards": shards, "reshard": reshard,
              "exchange": exchange}[task]
        torch.save(fn(spec, rank, world), path_out)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5], sys.argv[6])
