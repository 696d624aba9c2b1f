"""The training step on one device.

Port of the replicated path of ``dlrover_tpu/train/train_step.py``:
``init_train_state``, ``TrainStepBuilder`` (``step_fn``, ``build``, the
fused K-step ``block_fn`` and ``build_block``) and ``build_eval_step``,
without a mesh, update sharding, fp8 or health sentinels.

One step: the loss and gradients of ``decoder.loss_fn`` (the mean over
micro-batches when ``grad_accum > 1``: gradients summed over the
micro-batches, then divided, as ``_accumulated_grads`` does), the global
gradient norm before clipping, and one optimizer update. The JAX step is
a pure function whose jitted call donates the old state; the port
updates the state's parameters and moments IN PLACE and returns the same
dict.
"""

from typing import Callable, Dict, List, Tuple

import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models import decoder
from dlrover_tpu_torch.models.config import ModelConfig
from dlrover_tpu_torch.train.optimizer import AdamW, global_norm

TrainState = Dict


def init_train_state(seed: int, cfg: ModelConfig, optimizer: AdamW,
                     device="cuda") -> TrainState:
    """``{"params": Decoder (trainable, cfg.param_dtype), "opt_state":
    optimizer state, "step": 0}`` with weights drawn on ``device`` from
    ``seed``."""
    dev = resolve_device(device)
    model = decoder.init(cfg, seed=seed, device=dev, trainable=True)
    return {"params": model,
            "opt_state": optimizer.init(dict(model.named_parameters())),
            "step": 0}


class TrainStepBuilder:
    """Builds the train step for a model config and an optimizer."""

    def __init__(self, cfg: ModelConfig, optimizer: AdamW,
                 grad_accum: int = 1, attn_impl: str = "auto",
                 device="cuda"):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.cfg = cfg
        self.optimizer = optimizer
        self.grad_accum = grad_accum
        self.attn_impl = attn_impl
        self.device = resolve_device(device)

    def _loss(self, model, batch):
        return decoder.loss_fn(model, batch, self.cfg,
                               attn_impl=self.attn_impl)

    def step_fn(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        """One optimizer step on ``batch`` (tensors with a leading batch
        axis, split into ``grad_accum`` micro-batches). Updates ``state``
        in place and returns it with the metrics ``loss``, ``tokens``,
        ``accuracy`` and ``grad_norm`` (0-dim tensors on the device)."""
        model = state["params"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        batch = {k: v.to(self.device) for k, v in batch.items()}
        a = self.grad_accum
        if a == 1:
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


def build_eval_step(cfg: ModelConfig, attn_impl: str = "auto",
                    device="cuda") -> Callable:
    """``eval_step(model, batch) → metrics`` of ``decoder.loss_fn``, no
    gradients."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(model, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        return decoder.loss_fn(model, batch, cfg, attn_impl=attn_impl)[1]

    return eval_step
