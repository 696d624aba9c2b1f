"""Numeric drift checking between runs.

Port of ``NumericChecker`` and ``check_finite`` from
``dlrover_tpu/observability/numeric.py``. Reference:
atorch/atorch/utils/numberic_checker.py (module-by-module output
comparison between two runs). Trees are nested dicts, lists and tuples of
tensors or arrays (a state dict, the step's gradients); a leaf's name is
its path as JAX's ``keystr`` writes it (``['layers']['wq']``, ``[0]``),
dicts walked in sorted key order as JAX flattens them, so a report on the
port's tree and one on the JAX tree name the same leaves alike. The
gradient sanitizer (``sanitize_grads``) waits for the optimizer zoo
(ROADMAP A17).
"""

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaf_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaf_paths(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _f32(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float()
    return torch.from_numpy(np.asarray(leaf, dtype=np.float32))


class NumericChecker:
    """Compare trees (params, grads, activations) between runs.

    ``compare(a, b)`` returns per-leaf max abs/rel error and ``allclose``
    a verdict at the given tolerances — the "precision alignment"
    workflow for porting a model between frameworks or dtypes.
    """

    def __init__(self, rtol: float = 1e-3, atol: float = 1e-5):
        self.rtol = rtol
        self.atol = atol

    def compare(self, a, b) -> Dict[str, Dict[str, float]]:
        report: Dict[str, Dict[str, float]] = {}
        for (name, la), (_, lb) in zip(_leaf_paths(a), _leaf_paths(b)):
            xa = _f32(la)
            xb = _f32(lb).to(xa.device)
            if xa.shape != xb.shape:
                report[name] = {"shape_mismatch": 1.0}
                continue
            diff = (xa - xb).abs()
            denom = torch.clamp(xb.abs(), min=self.atol)
            report[name] = {
                "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
                "max_rel_err": float((diff / denom).max())
                if diff.numel() else 0.0,
            }
        return report

    def allclose(self, a, b) -> bool:
        rep = self.compare(a, b)
        return all(
            "shape_mismatch" not in r
            and (r["max_abs_err"] <= self.atol
                 or r["max_rel_err"] <= self.rtol)
            for r in rep.values())


def check_finite(tree) -> List[str]:
    """Names of leaves containing any NaN/Inf (host-side, for
    debugging)."""
    return [name for name, leaf in _leaf_paths(tree)
            if not bool(torch.isfinite(_f32(leaf)).all())]
