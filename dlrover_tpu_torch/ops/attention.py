"""Attention helpers shared by the port's plain attention paths.

Port of ``dlrover_tpu/ops/attention.py::_repeat_kv``. Layout is the JAX
package's ``[batch, seq, heads, head_dim]``.
"""

import torch


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: repeat each of the ``Hkv`` heads ``n_rep`` times, head-major
    (KV head ``kh`` serves query heads ``kh*n_rep .. kh*n_rep+n_rep-1``)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return (
        k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)
    )
