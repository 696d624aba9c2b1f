"""Plain attention shared by the port's attention paths.

Port of ``dlrover_tpu/ops/attention.py``: ``_repeat_kv`` and
``mha_reference``. Layout is the JAX package's
``[batch, seq, heads, head_dim]``.
"""

from typing import Optional

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: repeat each of the ``Hkv`` heads ``n_rep`` times, head-major
    (KV head ``kh`` serves query heads ``kh*n_rep .. kh*n_rep+n_rep-1``)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return (
        k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)
    )


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    prefix_len: Optional[torch.Tensor] = None,
    window: int = 0,
) -> torch.Tensor:
    """Plain softmax attention. q ``[B, Sq, H, D]``, k/v ``[B, Sk, Hkv, D]``
    → ``[B, Sq, H, D]``, op for op the JAX reference: f32 scores, the
    causal mask aligned bottom-right (query i sees key j iff
    ``i >= j - (Sk - Sq)``), masked scores set to -1e30, and the
    probabilities cast to ``q.dtype`` before P·V.

    ``prefix_len`` ``[B]`` (causal only): keys before ``prefix_len[b]``
    are visible to every query (GLM prefix-LM). ``window`` (causal
    only): each query sees the last ``window`` positions."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hkv != h:
        k = _repeat_kv(k, h // hkv)
        v = _repeat_kv(v, h // hkv)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        mask = q_pos >= k_pos - (sk - sq)
        if window:
            if window < 0:
                raise ValueError(f"window must be >= 0, got {window}")
            if prefix_len is not None:
                raise ValueError("window and prefix_len are mutually exclusive")
            mask = mask & ((k_pos - (sk - sq)) > q_pos - window)
        if prefix_len is not None:
            pmask = mask[None] | (
                k_pos[None] < prefix_len.to(q.device)[:, None, None])
            logits = torch.where(pmask[:, None], logits, NEG_INF)
        else:
            logits = torch.where(mask[None, None], logits, NEG_INF)
    elif prefix_len is not None:
        raise ValueError("prefix_len requires causal=True")
    elif window:
        raise ValueError("window requires causal=True")
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
