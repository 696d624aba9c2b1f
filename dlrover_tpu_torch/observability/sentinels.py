"""Health sentinels: numeric-health scalars of the train step.

Port of ``dlrover_tpu/observability/sentinels.py``. A handful of scalar
reductions over tensors the step already holds (the gradients, the
updates, the parameters), added to the step's metrics so they ride the
step's one existing device → host read: the trainer reads them with the
loss in a single copy (``train/trainer.py``). They are plain tensor
reductions in JAX as well, outside any Pallas kernel; here they stay
torch ops.

Keys (0-dim float32 tensors in the step's metrics):

* ``sent_nonfinite``      — count of non-finite gradient entries.
* ``sent_ovf_f16``        — fraction of finite grad entries that would
                            overflow float16 (|g| > 65504).
* ``sent_und_f16``        — fraction of finite NONZERO grad entries
                            below float16's min normal (6.1e-5).
* ``sent_ovf_bf16``       — same vs bfloat16's max finite (~3.39e38).
* ``sent_und_bf16``       — same vs bfloat16's min normal (~1.18e-38).
* ``sent_update_ratio``   — ‖update‖₂ / ‖params‖₂ (the parameters
                            before the update).
* ``sent_loss_nonfinite`` — 1.0 when the step loss is NaN/Inf.
* ``sent_sanitizer_skips``— the gradient sanitizer's skip count, when
                            the optimizer state carries one (the
                            sanitizer waits for ROADMAP A17, so no port
                            step has the key yet).

The JAX ``sent_fp8_sat`` reads fp8 delayed-scaling state, which waits
for ROADMAP A17's fp8: the key is absent, as in JAX with fp8 off.

Parity contract (as JAX's): the counts and fractions are IDENTICAL
between the replicated step and the zero1/zero2 steps. Counts are exact
integers (summed in int64 here, carried as float32 across ranks, exact
below 2**24); fraction denominators are static Python ints (the global
parameter count), so the zero padding of the ZeRO flat stream — finite,
excluded from the underflow test by the ``g != 0`` condition — cannot
skew them. The norm-based ``sent_update_ratio`` reduces in another order
on the flat stream and is held to a tolerance instead.
"""

from typing import Dict, Iterable, Optional

import torch

from dlrover_tpu_torch.train.optimizer import global_norm

# dtype range thresholds the overflow/underflow fractions test against
# (each exact in float32)
F16_MAX = 65504.0
F16_TINY = 6.103515625e-05     # float16 min normal
BF16_MAX = 3.3895313892515355e38
BF16_TINY = 1.1754943508222875e-38  # bfloat16 min normal (== f32 tiny)

# order of the count lanes grad_counts packs (stable across the packed
# all-reduce of the sharded steps and the metrics unpack)
COUNT_KEYS = (
    "sent_nonfinite",
    "sent_ovf_f16",
    "sent_und_f16",
    "sent_ovf_bf16",
    "sent_und_bf16",
)


def _leaf_counts(g: torch.Tensor) -> torch.Tensor:
    """[5] int64 count vector for one gradient tensor (lanes:
    COUNT_KEYS), the JAX lanes by fewer passes: an infinity is above
    every max and a NaN compares false, so ``finite & (|g| > max)`` is
    ``(|g| > max) − inf``; a NaN and an infinity are below no min, so
    ``finite & (g ≠ 0) & (|g| < tiny)`` is ``(|g| < tiny) − zeros``.
    Exact zeros are out of the underflow lanes, so the ZeRO flat
    stream's bucket padding counts as the unpadded tensors do."""
    g = g.float()
    ag = g.abs()
    n_inf = torch.isinf(g).sum()
    n_zero = (g == 0).sum()
    return torch.stack([
        n_inf + torch.isnan(g).sum(),
        (ag > F16_MAX).sum() - n_inf,
        (ag < F16_TINY).sum() - n_zero,
        (ag > BF16_MAX).sum() - n_inf,
        (ag < BF16_TINY).sum() - n_zero,
    ])


def grad_counts(grads) -> torch.Tensor:
    """[5] float32 counts over gradient tensors (a dict, a sequence or
    one tensor)."""
    if isinstance(grads, torch.Tensor):
        grads = [grads]
    elif isinstance(grads, dict):
        grads = list(grads.values())
    total = _leaf_counts(grads[0])
    for g in grads[1:]:
        total = total + _leaf_counts(g)
    return total.float()


def static_size(tensors: Iterable[torch.Tensor]) -> int:
    """The total element count — a Python int, the static fraction
    denominator on every path."""
    return int(sum(t.numel() for t in tensors))


def counts_to_metrics(counts: torch.Tensor,
                      denom: int) -> Dict[str, torch.Tensor]:
    """Unpack a [5] count vector into the sentinel metrics.
    ``sent_nonfinite`` stays a raw count (any non-zero value is already
    an incident); the range lanes become fractions of ``denom``, the
    static total parameter count, multiplied by its float32 inverse as
    JAX does."""
    counts = counts.float()
    inv = 1.0 / max(int(denom), 1)  # rounded to float32 in the multiply
    out = {"sent_nonfinite": counts[0]}
    for i, key in enumerate(COUNT_KEYS[1:], start=1):
        out[key] = counts[i] * inv
    return out


def norm_ratio(update_norm: torch.Tensor,
               param_norm: torch.Tensor) -> torch.Tensor:
    """‖update‖ / ‖params‖ with a zero-safe denominator."""
    return update_norm / torch.clamp(param_norm, min=1e-12)


def update_ratio(updates, params) -> torch.Tensor:
    """‖updates‖₂ / ‖params‖₂ over two sets of tensors (dicts or
    sequences), each norm over every element."""

    def tensors(x):
        return list(x.values()) if isinstance(x, dict) else list(x)

    return norm_ratio(global_norm(tensors(updates)),
                      global_norm(tensors(params)))


def loss_nonfinite(loss: torch.Tensor) -> torch.Tensor:
    return (~torch.isfinite(loss)).float()


def sanitizer_count(opt_state) -> Optional[torch.Tensor]:
    """The cumulative skipped/zeroed-update count of a gradient
    sanitizer's state (``nonfinite_count``, the JAX state's field)
    inside an optimizer state, or None when it carries none."""
    found = []

    def walk(x):
        if isinstance(x, dict):
            for k, v in x.items():
                if k == "nonfinite_count":
                    found.append(torch.as_tensor(v))
                else:
                    walk(v)

    walk(opt_state)
    if not found:
        return None
    total = found[0]
    for c in found[1:]:
        total = total + c
    return total.float()
