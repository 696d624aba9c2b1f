"""Optimizer and learning-rate schedules.

Port of the AdamW branch of ``dlrover_tpu/train/optimizer.py``: the
schedules ``warmup_cosine`` and ``build_schedule`` (as plain functions of
the step, with optax's float32 arithmetic) and an AdamW whose numbers are
those of ``optax.chain(clip_by_global_norm(grad_clip), adamw(...))``:

- the clip of ``_make_clip_fn``: one global norm; each leaf kept when the
  norm is below ``grad_clip``, else ``(g / norm) * grad_clip``;
- ``scale_by_adam``: ``m = (1 − b1)·g + b1·m``, ``v = (1 − b2)·g² + b2·v``,
  bias corrections by ``1 − b**t`` with the incremented count, ``eps``
  outside the square root; ``m`` stored in ``mu_dtype`` (bf16 with
  ``state_dtype="bfloat16"``) after the update is formed. With bf16
  moments ``b1·m`` is a bf16 product with ``b1`` itself rounded to bf16
  (0.9 → 0.8984375), as JAX multiplies a weakly typed scalar;
- ``add_decayed_weights`` on EVERY leaf (optax's default mask is None);
- ``scale_by_learning_rate``, whose lr for update t reads the schedule at
  the count before the increment (so step 1's lr is 0 under warmup).

Parameters, gradients and state are dicts of tensors keyed by parameter
name; the update is applied IN PLACE (the port's counterpart of the JAX
step donating its state). ``fused=True`` is ``fused_adamw``: the same
numbers in one walk over the leaves with ``torch._foreach_*`` ops.
"""

from typing import Callable, Dict, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]

_F32 = np.float32
_GROUP_ELEMS = 1 << 28


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule (polynomial of power 1) at ``count``."""
    if steps <= 0:
        return float(_F32(init))
    c = min(max(count, 0), steps)
    frac = _F32(1) - _F32(c) / _F32(steps)
    return float(_F32(_F32(init) - _F32(end)) * frac + _F32(end))


def _cosine(init: float, decay_steps: int, alpha: float, count: int) -> float:
    """optax.cosine_decay_schedule at ``count``."""
    c = _F32(min(float(count), float(decay_steps)))
    cos = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c / _F32(decay_steps)))
    decayed = _F32(1 - alpha) * cos + _F32(alpha)
    return float(_F32(init) * decayed)


def warmup_cosine(peak_lr: float, warmup_steps: int = 100,
                  decay_steps: int = 10000, end_lr_ratio: float = 0.1):
    """Linear warmup from 0 to ``peak_lr`` over ``warmup_steps``, then a
    cosine to ``peak_lr · end_lr_ratio`` at ``decay_steps``
    (``optax.warmup_cosine_decay_schedule``)."""
    end = peak_lr * end_lr_ratio
    alpha = 0.0 if peak_lr == 0.0 else end / peak_lr

    def sched(step: int) -> float:
        if step < warmup_steps:
            return _linear(0.0, peak_lr, warmup_steps, step)
        return _cosine(peak_lr, decay_steps - warmup_steps, alpha,
                       step - warmup_steps)

    return sched


def build_schedule(name: str, peak_lr: float, warmup_steps: int = 100,
                   decay_steps: int = 10000, end_lr_ratio: float = 0.1):
    """Named schedules: ``warmup_cosine``, ``warmup_linear``,
    ``constant_with_warmup`` (functions of the step) and ``constant``
    (the float ``peak_lr``)."""
    if name == "warmup_cosine":
        return warmup_cosine(peak_lr, warmup_steps, decay_steps, end_lr_ratio)
    if name == "warmup_linear":
        def sched(step):
            if step < warmup_steps:
                return _linear(0.0, peak_lr, warmup_steps, step)
            return _linear(peak_lr, peak_lr * end_lr_ratio,
                           max(1, decay_steps - warmup_steps),
                           step - warmup_steps)
        return sched
    if name == "constant_with_warmup":
        def sched(step):
            if step < warmup_steps:
                return _linear(0.0, peak_lr, warmup_steps, step)
            return float(_F32(peak_lr))
        return sched
    if name == "constant":
        return peak_lr
    raise NotImplementedError(
        f"schedule {name!r} is not ported yet (ROADMAP A17)")


def _bias_correction(decay: float, count: int) -> float:
    """``1 − decay**count`` in float32, as optax computes it."""
    return float(_F32(1) - np.power(_F32(decay), _F32(count)))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (f32, on device)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """``init(params) → state``; ``update_(params, grads, state)`` applies
    one update in place. ``state`` is ``{"step": int, "m": {...},
    "v": {...}}`` with moments shaped like the params (``m`` in bf16 under
    ``state_dtype="bfloat16"``)."""

    def __init__(self, learning_rate: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float = 0.0,
                 state_dtype=None, fused: bool = False):
        if state_dtype not in (None, "bfloat16"):
            raise NotImplementedError(
                f"state_dtype={state_dtype!r}: only None and 'bfloat16' "
                "moments are ported (ROADMAP A17)")
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.mu_dtype = torch.bfloat16 if state_dtype == "bfloat16" else None
        self.fused = fused

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(_F32(lr(count) if callable(lr) else lr))

    def init(self, params: Dict[str, torch.Tensor]):
        return {
            "step": 0,
            "m": {n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                  for n, p in params.items()},
            "v": {n: torch.zeros_like(p) for n, p in params.items()},
        }

    def _decayed(self, m):
        """``b1·m`` as optax forms it: in m's dtype, with b1 cast to it."""
        if m.dtype == torch.float32:
            return self.b1 * m
        return (m * torch.tensor(self.b1, dtype=m.dtype)).float()

    def _clip_factors(self, grads):
        """(divisor, multiplier) per leaf: (1, 1) under the clip norm,
        else (norm, grad_clip), so ``(g / div) * mul`` is the clip's
        ``select`` without a host sync."""
        norm = global_norm(grads)
        keep = norm < self.grad_clip
        one = torch.ones_like(norm)
        return (torch.where(keep, one, norm),
                torch.where(keep, one, torch.full_like(norm, self.grad_clip)))

    @torch.no_grad()
    def update_(self, params, grads, state) -> None:
        names = list(params)
        lr = self.lr(state["step"])  # the count before the increment
        state["step"] += 1
        bc1 = _bias_correction(self.b1, state["step"])
        bc2 = _bias_correction(self.b2, state["step"])
        g = [grads[n] for n in names]
        if self.grad_clip and self.grad_clip > 0:
            div, mul = self._clip_factors(g)
        else:
            div = mul = None
        if self.fused:
            # groups of leaves bound the walk's temporaries (~1 GiB each)
            i = 0
            while i < len(names):
                j, size = i, 0
                while j < len(names) and (j == i or size < _GROUP_ELEMS):
                    size += g[j].numel()
                    j += 1
                self._fused(names[i:j], params, g[i:j], state, lr, bc1, bc2,
                            div, mul)
                i = j
            return
        for n, gi in zip(names, g):
            p, m, v = params[n], state["m"][n], state["v"][n]
            if div is not None:
                gi = (gi / div.to(gi.dtype)) * mul.to(gi.dtype)
            m2 = (1 - self.b1) * gi + self._decayed(m)
            v2 = (1 - self.b2) * (gi * gi) + self.b2 * v
            u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            u = -lr * u
            p.add_(u)
            m.copy_(m2)
            v.copy_(v2)

    def _fused(self, names, params, g, state, lr, bc1, bc2, div, mul):
        """The same arithmetic, one ``_foreach`` op per term over every
        leaf: one walk over the state instead of a chain of trees."""
        p = [params[n] for n in names]
        m = [state["m"][n] for n in names]
        v = [state["v"][n] for n in names]
        if div is not None:
            g = torch._foreach_div(g, div)
            torch._foreach_mul_(g, mul)
        m_prev = [self._decayed(t) for t in m] if self.mu_dtype else \
            torch._foreach_mul(m, self.b1)
        m2 = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_add_(m2, m_prev)
        v2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(v2, 1 - self.b2)
        torch._foreach_add_(v2, torch._foreach_mul(v, self.b2))
        den = torch._foreach_div(v2, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(m2, bc1)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(p, u)
        torch._foreach_copy_(m, m2)
        torch._foreach_copy_(v, v2)


def fused_adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.0,
                grad_clip: float = 0.0, state_dtype=None) -> AdamW:
    """AdamW with the clip, the moments, the decay and the lr in one walk
    over the leaves; numerically the optax chain."""
    return AdamW(learning_rate, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay, grad_clip=grad_clip,
                 state_dtype=state_dtype, fused=True)


def make_optimizer(name: str = "adamw", learning_rate: float = 3e-4,
                   weight_decay: float = 0.1, b1: float = 0.9,
                   b2: float = 0.95, grad_clip: float = 1.0,
                   warmup_steps: int = 100, decay_steps: int = 100000,
                   schedule: str = "warmup_cosine", state_dtype=None,
                   fused: bool = False) -> AdamW:
    """The training optimizer, with the JAX package's defaults. Only
    ``adamw`` is ported, with f32 or bf16 first moments, fused or not."""
    if name != "adamw":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP A17)")
    if schedule in ("none", "const", "constant"):
        lr = learning_rate
    else:
        lr = build_schedule(schedule, learning_rate, warmup_steps,
                            decay_steps)
    return AdamW(lr, b1=b1, b2=b2, weight_decay=weight_decay,
                 grad_clip=grad_clip or 0.0, state_dtype=state_dtype,
                 fused=fused)
