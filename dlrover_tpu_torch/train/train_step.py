"""The training step on one device.

Port of ``dlrover_tpu/train/train_step.py``: ``init_train_state``,
``TrainStepBuilder`` (``step_fn``, ``build``, the fused K-step
``block_fn`` and ``build_block``) and ``build_eval_step``, over no mesh
or a dp × fsdp × sp × tp mesh (``parallel/mesh.py``),
replicated or with ZeRO update sharding (on dp, or on dp × fsdp and dp ×
tp), on the f32, bf16 or int8 gradient wire, without fp8 or health
sentinels.

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
the flat bucket stream (``parallel/sharding.py``) and exchanged a
bucket at a time on the wire ``comm.wire_for(mesh, "dp")`` names (f32:
a reduce-scatter; bf16, int8: an all-to-all, summed in f32), so each
rank gets the summed gradients of its columns: zero2 exchanges every
micro-batch and accumulates the shard, zero1 accumulates the full local
gradient and exchanges once. The shard is divided by a after the
exchange; the global gradient norm is the square sums all-reduced over
the group; AdamW (its moments this rank's columns of every bucket)
updates this rank's columns of the packed parameters, a bucket's row at
a time (``_update_columns``), ``p_shard + u`` before the gather as JAX
``:1040-1054`` does; one all-gather brings
every rank's columns back and they are unpacked into the parameters.

Under a dp × sp ``mesh`` (the JAX step's ``batch_sharding`` over
``("dp", "fsdp")`` rows and the sp sequence) each rank's batch is the
rows of its dp coordinate; the step keeps its sp block of every
per-token array (``data_utils.sequence_block``; ``prefix_len`` stays per
row) and runs the model's sequence-parallel attention. The parameters are
replicated on both axes, so the global mask sum and the one flat
all-reduce run over the whole dp × sp world, as above; update sharding
falls back to the replicated update there, with its reason, as the JAX
resolver falls back on a mesh axis it does not shard over.

Under a mesh with fsdp or tp above 1 (sharded parameters:
``Decoder(mesh=)``), with or without sp, each rank's batch is the rows
of its dp and fsdp coordinates (``data_utils.dp_rows``), the same on
its sp and tp ranks, of which it keeps its sp block. The mask sum is
summed over dp × fsdp × sp (``BATCH_AXES``; the tp ranks hold the same
tokens). After the backward each leaf's gradient is summed over exactly
the axes where its contributions differ (``reduce_axes``): dp and sp
(each sp rank's gradient covers its sequence block only), and fsdp
unless the leaf is cut over fsdp (its gather's backward already
reduce-scattered it), and tp for ``wk``/``wv``, replicated over tp
while each tp rank uses its own KV heads; never over tp for a leaf
whose gradient is already the same on every tp rank, as the norm
scales' are after Megatron's ``copy_to_tp``. AdamW runs on the local
shards, its moments shaped like them (the JAX ``state_shardings``); the
global gradient norm counts every element once: each rank's square sums
divided by the ranks of its fsdp × sp × tp group that hold the same
values, then summed over that group. ZeRO update sharding on a mesh
with sp falls back to this replicated update with the JAX reason
(``resolve_update_sharding``: "non-dp mesh axes beyond fsdp/tp in
use").

ZeRO on a dp × fsdp or dp × tp mesh (the JAX hybrid step: manual over
dp, fsdp and tp left to the partitioner; the f32 wire only, as the JAX
gate asks). The plan packs the GLOBAL leaves, and a rank's moments are
the JAX hybrid layout's: its dp coordinate's columns of every bucket
(``P(None, "dp")``), the same columns on every fsdp × tp peer (the port
cuts a dp column block no further: each peer updates the same columns,
as the JAX partitioner keeps the flat view replicated over fsdp and
tp). After each backward (zero2) or the last (zero1) every leaf's
gradient is summed over its ``reduce_axes`` but dp, so each rank holds
its shard of the dp-local gradient; the shards are gathered over the
fsdp × tp group and laid into the global stream, each at its global
index (``sharding.pack_shards``: copied, so a leaf replicated over tp
lands once), and exchanged over the dp group. The loss and accuracy sum
over dp × fsdp, the columns' square sums over dp only (every peer holds
the same columns: a sum over fsdp or tp would count them again). The
update runs on the parameters' dp columns, and after the dp all-gather
each rank keeps its own shards (``sharding.unpack_shard``), as JAX
re-pins the rule shardings. A rank keeps its updated columns for the
next step (``_param_columns``), so the parameters' global stream is
assembled over fsdp × tp only for the first step and after something
else wrote the parameters (a restore).

The JAX step is a pure function whose jitted call donates the old state;
the port updates the state's parameters and moments IN PLACE and returns
the same dict.
"""

import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models import decoder
from dlrover_tpu_torch.models.config import ModelConfig
from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.parallel.collectives import all_gather_dim, all_reduce_
from dlrover_tpu_torch.parallel import sharding as shd
from dlrover_tpu_torch.parallel.mesh import Mesh, check_ported, data_axes
from dlrover_tpu_torch.train.data_utils import sequence_block
from dlrover_tpu_torch.train.distributed import process_count, process_index
from dlrover_tpu_torch.train.optimizer import (
    AdamW,
    global_norm,
    sharded_global_norm,
)

TrainState = Dict
#: the order of a leaf's ``reduce_axes`` (the mesh's)
REDUCE_ORDER = ("dp", "fsdp", "sp", "tp")
#: the group the sharded global norm sums over: every rank of it holds
#: one shard of each leaf or a replica of one
NORM_AXES = ("fsdp", "sp", "tp")
#: the mesh axes over which a rank's tokens differ (in ``REDUCE_ORDER``):
#: the mask sum, the loss and the accuracy are summed over them on a
#: sharded mesh
BATCH_AXES = data_axes() + ("sp",)


def init_train_state(seed: int, cfg: ModelConfig, optimizer: AdamW,
                     device="cuda", comm: Optional[shd.CommConfig] = None,
                     group=None, mesh=None) -> TrainState:
    """``{"params": Decoder (trainable, cfg.param_dtype), "opt_state":
    optimizer state, "step": 0}`` with weights drawn on ``device`` from
    ``seed``. When ``comm``'s update sharding resolves active over
    ``group`` (as the step builder resolves it), the optimizer state is
    born on this rank's columns of the flat bucket view: ``{"m":
    {"flat": [n_buckets, S]}, "v": {...}, "step": 0}``. Under a
    ``mesh`` with fsdp or tp above 1 the parameters and moments are this
    rank's shards of the same global state (each weight drawn whole, one
    at a time, and cut)."""
    dev = resolve_device(device)
    model = decoder.init(cfg, seed=seed, device=dev, trainable=True,
                         mesh=mesh)
    params = dict(model.named_parameters())
    active, _, plan = shd.resolve_update_sharding(
        cfg, params, process_count(group), comm, mesh)
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
        fsdp × sp × tp), or None. ``comm``: the update sharding
        asked for (resolved here: ``update_sharding``,
        ``update_sharding_reason``, ``plan``). ``group``: the
        data-parallel process group every collective of the step runs
        over (the world by default)."""
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
        self.sharded = mesh is not None and mesh.sharded
        if mesh is not None:
            check_ported(mesh.shape)
            if self.sharded:  # refuses an uneven split
                self.layout = decoder.param_layout(cfg, mesh)
            if mesh.size != self.world:
                raise ValueError(f"the mesh {mesh.shape} covers {mesh.size} "
                                 f"ranks, the world has {self.world}")
        if self.sharded:
            # by parameter name: the axes its gradient is summed over, and
            # how many ranks of the fsdp x sp x tp group hold its values
            self.reduce_axes, self.replicas = {}, {}
            for name, shard in self.layout.items():
                axes = {"dp", "sp"}
                if "fsdp" not in shard.axes:
                    axes.add("fsdp")
                if (shard.path in decoder.TP_SPLIT_USE
                        and "tp" not in shard.axes):
                    axes.add("tp")
                self.reduce_axes[name] = tuple(
                    a for a in REDUCE_ORDER if a in axes)
                self.replicas[name] = mesh.size_of(
                    [a for a in NORM_AXES if a not in shard.axes])
        self.comm = comm
        params = dict(decoder.Decoder(cfg, device="meta",
                                      trainable=True).named_parameters())
        (self.update_sharding, self.update_sharding_reason,
         self.plan) = shd.resolve_update_sharding(
            cfg, params, self.world, comm, mesh)
        self.update_mode = comm.update_mode if self.update_sharding else ""
        self.wire = comm.wire_for(mesh, "dp") if self.update_sharding else None
        # the exchange's group and this rank's columns: the dp axis of a
        # sharded mesh, else the data-parallel group
        self.dp_group, self.dp_rank = ((mesh.group("dp"), mesh.coord("dp"))
                                       if self.sharded
                                       else (group, self.rank))
        if self.update_sharding and self.sharded:
            # every peer of this rank's fsdp x tp group, in group order:
            # where its shards lie in the global leaves
            self.peer_layouts = [
                decoder.param_layout(cfg, Mesh(mesh.shape, r))
                for r in mesh.ranks(("fsdp", "tp"))]
        # the last update's parameter columns and what they were read
        # from (``_param_columns``)
        self._kept = None

    @property
    def shard(self):
        """(plan, dp rank) of the flat optimizer state when update
        sharding is active, else None: what ``convert.train_state_leaves``
        needs to lay the state out."""
        return (self.plan, self.dp_rank) if self.update_sharding else None

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
        count = _global_count(mb, self.device, self.group, self.mesh)
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

    def _sum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """``t`` summed in place over this rank's group along ``axes``
        (nothing when that group is this rank alone)."""
        if self.mesh.size_of(axes) > 1:
            all_reduce_(t, self.mesh.group(axes))
        return t

    def _sharded_grads(self, model, params, batch) -> Dict:
        """The loss and gradients on a sharded mesh (module docstring):
        per micro-batch the mask sum over ``BATCH_AXES``, then the
        backward; then one flat f32 all-reduce for each set of
        ``reduce_axes`` (the loss and accuracy ride with the
        ``BATCH_AXES`` one, the norm scales'), divided by ``grad_accum``;
        the global norm. Leaves the mean gradients in ``.grad``."""
        a, sums = self.grad_accum, {}
        for mb in self._micro(batch):
            self._local_micro(model, mb, sums)
        buckets: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for n, p in params.items():
            buckets.setdefault(self.reduce_axes[n], []).append(p.grad)
        data = BATCH_AXES  # the norm scales' reduce_axes
        stats = torch.stack([sums["loss"], sums["accuracy"]]).float()
        buckets.setdefault(data, [])
        for axes, grads in buckets.items():
            extra = [stats] if axes == data else []
            flat = torch.cat([g.reshape(-1).float() for g in grads] + extra)
            self._sum(flat, axes)
            if a > 1:
                flat /= a
            at = 0
            for g in grads:
                g.copy_(flat[at: at + g.numel()].view(g.shape))
                at += g.numel()
            if extra:
                stats = flat[at:]
        names = list(params)
        norm = sharded_global_norm(
            [params[n].grad for n in names],
            [self.replicas[n] for n in names],
            self.mesh.group(NORM_AXES))
        return {"loss": stats[0].clone(), "accuracy": stats[1].clone(),
                "tokens": sums["tokens"], "grad_norm": norm}

    def _stream(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global flat stream of ``tensors`` (by param name): packed
        as they are, or, on a sharded mesh, every fsdp × tp peer's shards
        gathered (one all-gather) and laid at their global indices. The
        dict is emptied once its values are copied, so that what only it
        still holds is freed before the gather."""
        if not self.sharded:
            return shd.pack_flat(self.cfg, tensors, self.plan)
        shapes = {n: t.shape for n, t in tensors.items()}
        mine = torch.cat([t.reshape(-1).float() for t in tensors.values()])
        tensors.clear()
        n_mine = mine.numel()
        got = all_gather_dim(mine, 0, self.mesh.group(("fsdp", "tp")))
        del mine
        blocks = []
        for i in range(len(self.peer_layouts)):
            at, own = i * n_mine, {}
            for n, shape in shapes.items():
                own[n] = got[at: at + shape.numel()].view(shape)
                at += shape.numel()
            blocks.append(own)
        return shd.pack_shards(self.cfg, blocks, self.peer_layouts,
                               self.plan)

    def _grad_stream(self, params) -> torch.Tensor:
        """The stream of this rank's dp-local gradients: on a sharded
        mesh each leaf first summed over its ``reduce_axes`` but dp. The
        parameters' ``.grad`` are dropped: the stream holds them now."""
        if self.sharded:
            buckets: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
            for n, p in params.items():
                axes = tuple(a for a in self.reduce_axes[n] if a != "dp")
                if axes and self.mesh.size_of(axes) > 1:
                    buckets.setdefault(axes, []).append(p.grad)
            for axes, grads in buckets.items():
                flat = torch.cat([g.reshape(-1).float() for g in grads])
                self._sum(flat, axes)
                at = 0
                for g in grads:
                    g.copy_(flat[at: at + g.numel()].view(g.shape))
                    at += g.numel()
            buckets = grads = flat = None  # no reference past the gather
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        return self._stream(grads)

    def _exchange(self, params) -> torch.Tensor:
        """This rank's columns of the dp-summed gradient stream, under a
        ``zero.exchange`` span (the host's time in the gather and the
        exchange, the wire's bytes)."""
        with get_tracer().span("zero.exchange", wire=self.wire) as span:
            out = shd.exchange_buckets(self._grad_stream(params), self.plan,
                                       self.dp_group, wire=self.wire)
            span.args["bytes"] = shd.wire_bytes(self.plan, self.wire)
        return out

    def _param_columns(self, params) -> torch.Tensor:
        """This rank's dp columns of the parameters' f32 stream. The last
        step's updated columns are kept while the parameters are the same
        tensors at the versions that step's unpack left (a restore, or any
        other write, moves a version): a step then reads them from no
        collective and builds no global parameter stream."""
        kept = self._kept
        if kept is not None and len(kept[0]) == len(params) and all(
                ref() is p and v == p._version
                for (ref, v), p in zip(kept[0], params.values())):
            return kept[1]
        self._kept = None
        return self._stream(dict(params))[:, self.plan.columns(
            self.dp_rank)].contiguous()

    def _update_columns(self, p_shard: torch.Tensor, shards: torch.Tensor,
                        opt_state: Dict, norm: torch.Tensor) -> None:
        """AdamW on this rank's columns, a bucket's row as a leaf: the
        update's temporaries are a row's size, not the whole shard's (the
        arithmetic is elementwise, so the bits are the same)."""
        rows = range(p_shard.shape[0])
        state = {"step": opt_state["step"],
                 "m": {i: opt_state["m"]["flat"][i] for i in rows},
                 "v": {i: opt_state["v"]["flat"][i] for i in rows}}
        self.optimizer.update_({i: p_shard[i] for i in rows},
                               {i: shards[i] for i in rows}, state, norm=norm)
        opt_state["step"] = state["step"]

    def _keep_columns(self, params, p_shard: torch.Tensor) -> None:
        """Keep ``p_shard``, the columns just unpacked into ``params``, for
        ``_param_columns``: beside each parameter (weakly) and its
        version now."""
        self._kept = ([(weakref.ref(p), p._version)
                       for p in params.values()], p_shard)

    def _zero_sums(self, stats: torch.Tensor, sq: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss and accuracy summed over the data ranks, the columns'
        square sum over dp): one all-reduce over the group, or, on a
        sharded mesh, the stats over dp × fsdp and the square sum over dp
        (every fsdp × tp peer holds the same columns)."""
        if not self.sharded:
            red = all_reduce_(torch.cat([stats, sq.reshape(1)]), self.group)
            return red[:2], red[2]
        return self._sum(stats, data_axes()), self._sum(sq, "dp")

    def _zero_step(self, model, params, batch, opt_state) -> Dict:
        """The update-sharded step (module docstring); the parameters
        updated in place, the metrics returned."""
        cfg, plan, a = self.cfg, self.plan, self.grad_accum
        defer = self.update_mode == "zero1"
        shards, sums = None, {}
        for mb in self._micro(batch):
            self._local_micro(model, mb, sums)
            if not defer:
                got = self._exchange(params)
                shards = got if shards is None else shards + got
                for p in params.values():
                    p.grad = None
        if defer:
            shards = self._exchange(params)
            for p in params.values():
                p.grad = None
        if a > 1:
            # divide AFTER the exchange, where the JAX step divides
            shards = shards / a
        stats, sq = self._zero_sums(
            torch.stack([sums["loss"], sums["accuracy"]]).float(),
            shards.square().sum())
        norm = torch.sqrt(sq)
        p_shard = self._param_columns(params)
        self._update_columns(p_shard, shards, opt_state, norm)
        del shards
        full = shd.all_gather_columns(p_shard, plan, self.dp_group)
        if self.sharded:
            shd.unpack_shard(cfg, full, params, plan, self.layout)
        else:
            shd.unpack_flat(cfg, full, params, plan)
        del full
        self._keep_columns(params, p_shard)
        return {"loss": stats[0] / a, "accuracy": stats[1] / a,
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
        if self.sharded:
            metrics = self._sharded_grads(model, params, batch)
        elif self.world > 1:
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
        if "grad_norm" not in metrics:
            metrics["grad_norm"] = global_norm(list(grads.values()))
        self.optimizer.update_(params, grads, state["opt_state"],
                               norm=metrics["grad_norm"]
                               if self.sharded else None)
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


def _global_count(batch, device, group=None, mesh=None) -> torch.Tensor:
    """The mask sum over the group (W > 1): the denominator of the
    global mean loss, as ``_dp_grads`` and the eval step take it. On a
    sharded ``mesh`` the sum runs over ``BATCH_AXES`` only: the tp ranks
    of a group hold the same tokens, and a sum over them would count each
    token tp times."""
    mask = batch.get("mask")
    if mask is None:
        count = torch.tensor(float(batch["targets"].numel()), device=device)
    else:
        count = mask.float().sum()
    if mesh is not None and mesh.sharded:
        if mesh.size_of(BATCH_AXES) > 1:
            all_reduce_(count, mesh.group(BATCH_AXES))
        return count
    return all_reduce_(count, group)


def build_eval_step(cfg: ModelConfig, attn_impl: str = "auto",
                    device="cuda", mesh=None) -> Callable:
    """``eval_step(model, batch) → metrics`` of ``decoder.loss_fn``, no
    gradients. In a world of W > 1 the metrics are the global ones (the
    mask sum, then the loss and accuracy, summed over the world, as the
    train step takes them); under a ``mesh`` the batch is cut as the
    train step cuts it, and on a sharded one the sums run over
    ``BATCH_AXES``."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(model, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if mesh is not None:
            batch = sequence_block(batch, mesh)
        if process_count() == 1:
            return decoder.loss_fn(model, batch, cfg, attn_impl=attn_impl,
                                   mesh=mesh)[1]
        count = _global_count(batch, dev, mesh=mesh)
        m = decoder.loss_fn(model, batch, cfg, attn_impl=attn_impl,
                            denom=torch.clamp(count, min=1.0), mesh=mesh)[1]
        sums = torch.stack([m["loss"].float(), m["accuracy"].float()])
        if mesh is None or not mesh.sharded:
            all_reduce_(sums)
        elif mesh.size_of(BATCH_AXES) > 1:
            all_reduce_(sums, mesh.group(BATCH_AXES))
        return dict(m, loss=sums[0], accuracy=sums[1], tokens=count)

    return eval_step
