"""The training step on one device.

Port of ``dlrover_tpu/train/train_step.py``: ``init_train_state``,
``TrainStepBuilder`` (``step_fn``, ``build``, the fused K-step
``block_fn`` and ``build_block``) and ``build_eval_step``, over no mesh
or a dp × sp mesh (``parallel/mesh.py``), replicated or with ZeRO update
sharding on the f32 wire, without fp8 or health sentinels.

In a ``torch.distributed`` data-parallel group of W > 1 processes (the
world, or the ``group`` given: the survivors after a live reshard) the
step is the JAX step under a data-parallel mesh: each rank holds its
rows of the global batch; the loss divides by the GLOBAL mask sum
(all-reduced first, as ``loss_fn`` under a dp mesh divides by the global
sum, so ranks with unequal masks train the model the one-process step
would). With ``grad_accum`` a > 1 each rank's rows are cut into a
micro-batches (as the JAX step lays a global batch out, micro-batch i is
global rows [i·B/a, (i+1)·B/a), each rank its block of them), each
divided by its own global mask sum; the gradients
are summed over the micro-batches and the ranks, then divided by a, as
``_accumulated_grads`` does. At W = 1 no collective runs.

Replicated: after the backward the gradients, with the loss and
accuracy, go through one flat f32 all-reduce.

Update-sharded (``comm.update_sharding``, JAX ``_sharded_step_fn``; the
parameters stay whole f32 on every rank): the gradients are packed into
the flat bucket stream (``parallel/sharding.py``) and reduce-scattered
a bucket at a time, so each rank gets the summed gradients of its
columns: zero2 exchanges every micro-batch and accumulates the shard,
zero1 accumulates the full local gradient and exchanges once. The shard
is divided by a after the exchange; the global gradient norm is the
square sums all-reduced over the group; AdamW (its moments this rank's
columns of every bucket) updates this rank's columns of the packed
parameters, ``p_shard + u`` before the gather as JAX ``:1040-1054``
does; one all-gather brings every rank's columns back and they are
unpacked into the parameters.

Under a dp × sp ``mesh`` (the JAX step's ``batch_sharding`` over
``("dp", "fsdp")`` rows and the sp sequence) each rank's batch is the
rows of its dp coordinate; the step keeps its sp block of every
per-token array (``data_utils.sequence_block``; ``prefix_len`` stays per
row) and runs the model's sequence-parallel attention. The parameters are
replicated on both axes, so the global mask sum and the one flat
all-reduce run over the whole dp × sp world, as above; update sharding
falls back to the replicated update there, with its reason, as the JAX
resolver falls back on a mesh axis it does not shard over.

The JAX step is a pure function whose jitted call donates the old state;
the port updates the state's parameters and moments IN PLACE and returns
the same dict.
"""

from typing import Callable, Dict, List, Optional, Tuple

import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models import decoder
from dlrover_tpu_torch.models.config import ModelConfig
from dlrover_tpu_torch.parallel.collectives import all_reduce_
from dlrover_tpu_torch.parallel import sharding as shd
from dlrover_tpu_torch.parallel.mesh import check_ported
from dlrover_tpu_torch.train.data_utils import sequence_block
from dlrover_tpu_torch.train.distributed import process_count, process_index
from dlrover_tpu_torch.train.optimizer import AdamW, global_norm

TrainState = Dict


def init_train_state(seed: int, cfg: ModelConfig, optimizer: AdamW,
                     device="cuda", comm: Optional[shd.CommConfig] = None,
                     group=None, mesh=None) -> TrainState:
    """``{"params": Decoder (trainable, cfg.param_dtype), "opt_state":
    optimizer state, "step": 0}`` with weights drawn on ``device`` from
    ``seed``. When ``comm``'s update sharding resolves active over
    ``group`` (as the step builder resolves it), the optimizer state is
    born on this rank's columns of the flat bucket view: ``{"m":
    {"flat": [n_buckets, S]}, "v": {...}, "step": 0}``."""
    dev = resolve_device(device)
    model = decoder.init(cfg, seed=seed, device=dev, trainable=True)
    params = dict(model.named_parameters())
    active, _, plan = shd.resolve_update_sharding(
        cfg, params, process_count(group), comm,
        None if mesh is None else mesh.shape)
    if active:
        flat = {"flat": torch.zeros((plan.n_buckets, plan.bucket_elems
                                     // plan.dp), device=dev)}
        return {"params": model, "opt_state": optimizer.init(flat),
                "step": 0}
    return {"params": model, "opt_state": optimizer.init(params),
            "step": 0}


class TrainStepBuilder:
    """Builds the train step for a model config and an optimizer."""

    def __init__(self, cfg: ModelConfig, optimizer: AdamW,
                 grad_accum: int = 1, attn_impl: str = "auto",
                 device="cuda", mesh=None,
                 comm: Optional[shd.CommConfig] = None, group=None):
        """``mesh``: a ``parallel.mesh.Mesh`` over the whole world (dp ×
        sp), or None. ``comm``: the update sharding asked for (resolved
        here: ``update_sharding``, ``update_sharding_reason``, ``plan``).
        ``group``: the data-parallel process group every collective of
        the step runs over (the world by default)."""
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.cfg = cfg
        self.optimizer = optimizer
        self.grad_accum = grad_accum
        self.attn_impl = attn_impl
        self.device = resolve_device(device)
        self.group = group
        self.world = process_count(group)
        self.rank = process_index(group)
        self.mesh = mesh
        if mesh is not None:
            check_ported(mesh.shape)
            if mesh.size != self.world:
                raise ValueError(f"the mesh {mesh.shape} covers {mesh.size} "
                                 f"ranks, the world has {self.world}")
        self.comm = comm
        params = dict(decoder.Decoder(cfg, device="meta",
                                      trainable=True).named_parameters())
        (self.update_sharding, self.update_sharding_reason,
         self.plan) = shd.resolve_update_sharding(
            cfg, params, self.world, comm,
            None if mesh is None else mesh.shape)
        self.update_mode = comm.update_mode if self.update_sharding else ""

    @property
    def shard(self):
        """(plan, rank) of the flat optimizer state when update sharding
        is active, else None: what ``convert.train_state_leaves`` needs to
        lay the state out."""
        return (self.plan, self.rank) if self.update_sharding else None

    def _loss(self, model, batch, denom=None):
        return decoder.loss_fn(model, batch, self.cfg,
                               attn_impl=self.attn_impl, denom=denom,
                               mesh=self.mesh)

    def _micro(self, batch) -> List[Dict]:
        """This rank's rows cut into the ``grad_accum`` micro-batches."""
        a = self.grad_accum
        if a == 1:
            return [batch]
        return [{k: v.reshape((a, v.shape[0] // a) + v.shape[1:])[i]
                 for k, v in batch.items()} for i in range(a)]

    def _local_micro(self, model, mb, sums) -> None:
        """One micro-batch's backward over its global mask sum; its
        loss, accuracy and tokens added to ``sums``."""
        count = _global_count(mb, self.device, self.group)
        loss, m = self._loss(model, mb, denom=torch.clamp(count, min=1.0))
        loss.backward()  # .grad sums over the micro-batches
        for k, v in (("loss", m["loss"]), ("accuracy", m["accuracy"]),
                     ("tokens", count)):
            sums[k] = sums.get(k, 0.0) + v.float()

    def _dp_grads(self, model, params, batch) -> Dict:
        """The data-parallel loss and gradients (W > 1): per micro-batch
        the global mask sum first, then the backward; then one flat f32
        all-reduce of every gradient with the loss and accuracy, divided
        by ``grad_accum``. Leaves the mean gradients in ``.grad``."""
        a, sums = self.grad_accum, {}
        for mb in self._micro(batch):
            self._local_micro(model, mb, sums)
        grads = [p.grad for p in params.values()]
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [sums["loss"].reshape(1),
                            sums["accuracy"].reshape(1)])
        all_reduce_(flat, self.group)
        if a > 1:
            flat /= a
        at = 0
        for g in grads:
            g.copy_(flat[at: at + g.numel()].view(g.shape))
            at += g.numel()
        return {"loss": flat[-2].clone(), "accuracy": flat[-1].clone(),
                "tokens": sums["tokens"]}

    def _zero_step(self, model, params, batch, opt_state) -> Dict:
        """The update-sharded step (module docstring); the parameters
        updated in place, the metrics returned."""
        cfg, plan, group, a = self.cfg, self.plan, self.group, self.grad_accum
        defer = self.update_mode == "zero1"
        shards, sums = None, {}
        for mb in self._micro(batch):
            self._local_micro(model, mb, sums)
            if not defer:
                got = shd.exchange_buckets(
                    shd.pack_flat(cfg, {n: p.grad for n, p in params.items()},
                                  plan), plan, group)
                shards = got if shards is None else shards + got
                for p in params.values():
                    p.grad = None
        if defer:
            shards = shd.exchange_buckets(
                shd.pack_flat(cfg, {n: p.grad for n, p in params.items()},
                              plan), plan, group)
        if a > 1:
            # divide AFTER the exchange, where the JAX step divides
            shards = shards / a
        red = all_reduce_(torch.stack([sums["loss"], sums["accuracy"],
                                       shards.square().sum()]), group)
        norm = torch.sqrt(red[2])
        p_shard = shd.pack_flat(cfg, params, plan)[
            :, plan.columns(self.rank)].contiguous()
        self.optimizer.update_({"flat": p_shard}, {"flat": shards}, opt_state,
                               norm=norm)
        shd.unpack_flat(cfg, shd.all_gather_columns(p_shard, plan, group),
                        params, plan)
        return {"loss": red[0] / a, "accuracy": red[1] / a,
                "tokens": sums["tokens"], "grad_norm": norm}

    def step_fn(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        """One optimizer step on ``batch`` (tensors with a leading batch
        axis, split into ``grad_accum`` micro-batches). Updates ``state``
        in place and returns it with the metrics ``loss``, ``tokens``,
        ``accuracy`` and ``grad_norm`` (0-dim tensors on the device)."""
        model = state["params"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        if self.mesh is not None:
            batch = sequence_block(batch, self.mesh)
        a = self.grad_accum
        if self.update_sharding:
            metrics = self._zero_step(model, params, batch,
                                      state["opt_state"])
            for p in params.values():
                p.grad = None
            state["step"] += 1
            return state, metrics
        if self.world > 1:
            metrics = self._dp_grads(model, params, batch)
        elif a == 1:
            loss, metrics = self._loss(model, batch)
            loss.backward()
        else:
            micro = {k: v.reshape((a, v.shape[0] // a) + v.shape[1:])
                     for k, v in batch.items()}
            sums = {}
            for i in range(a):
                loss, m = self._loss(model, {k: v[i] for k, v in micro.items()})
                loss.backward()  # .grad sums over the micro-batches
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + v
            grads = [p.grad for p in params.values()]
            torch._foreach_div_(grads, float(a))
            metrics = {k: v / a for k, v in sums.items()}
            metrics["tokens"] = sums["tokens"]
        grads = {n: p.grad for n, p in params.items()}
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(list(grads.values()))
        self.optimizer.update_(params, grads, state["opt_state"])
        for p in params.values():
            p.grad = None
        state["step"] += 1
        return state, metrics

    def build(self) -> Callable:
        """The step callable ``step(state, batch) → (state, metrics)``. The
        state is updated in place: the port's counterpart of the JAX
        step's ``donate_argnums``."""
        return self.step_fn

    def block_fn(self, state: TrainState,
                 batches: List[Dict]) -> Tuple[TrainState, Dict]:
        """K train steps, one a batch of ``batches``, dispatched with no
        host read between them (the JAX block is a ``lax.scan`` of
        ``step_fn`` in one program). Each metric comes back stacked on the
        device, ``[K]``, for the caller to read when it needs it."""
        per_step = [self.step_fn(state, b)[1] for b in batches]
        return state, {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    def build_block(self) -> Callable:
        """The block callable ``block(state, batches) → (state, metrics)``,
        updating the state in place."""
        return self.block_fn


def _global_count(batch, device, group=None) -> torch.Tensor:
    """The mask sum over the group (W > 1): the denominator of the
    global mean loss, as ``_dp_grads`` and the eval step take it."""
    mask = batch.get("mask")
    if mask is None:
        count = torch.tensor(float(batch["targets"].numel()), device=device)
    else:
        count = mask.float().sum()
    return all_reduce_(count, group)


def build_eval_step(cfg: ModelConfig, attn_impl: str = "auto",
                    device="cuda", mesh=None) -> Callable:
    """``eval_step(model, batch) → metrics`` of ``decoder.loss_fn``, no
    gradients. In a world of W > 1 the metrics are the global ones (the
    mask sum, then the loss and accuracy, summed over the world, as the
    train step takes them); under a ``mesh`` the batch is cut as the
    train step cuts it."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(model, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if mesh is not None:
            batch = sequence_block(batch, mesh)
        if process_count() == 1:
            return decoder.loss_fn(model, batch, cfg, attn_impl=attn_impl,
                                   mesh=mesh)[1]
        count = _global_count(batch, dev)
        m = decoder.loss_fn(model, batch, cfg, attn_impl=attn_impl,
                            denom=torch.clamp(count, min=1.0), mesh=mesh)[1]
        sums = all_reduce_(torch.stack([m["loss"].float(),
                                        m["accuracy"].float()]))
        return dict(m, loss=sums[0], accuracy=sums[1], tokens=count)

    return eval_step
