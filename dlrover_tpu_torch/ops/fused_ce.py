"""Fused lm-head + softmax cross-entropy that never builds ``[N, V]`` logits.

Port of ``dlrover_tpu/ops/fused_ce.py``: the vocab axis is cut into
``block_v`` chunks, each chunk's logits ``scale · (x @ w_c)`` are made in
f32 from compute-dtype operands, and an online logsumexp, the target
logit and a running argmax carry across chunks. The backward recomputes
each chunk's logits, forms ``dlog = g_logz · p + onehot · g_tgt``, rounds
it to the compute dtype (as ``_fused_bwd`` does) and accumulates ``dx``
and the chunk's slice of ``dw`` in f32. Peak memory is one
``[N, block_v]`` f32 chunk.

Not a Pallas kernel in the JAX package, so none here: the chunk products
are matrix multiplications with f32 output (cuBLAS on the card).

``vocab_parallel_ce``: the same three outputs when the head's vocab is
cut over tp (``collectives.tp_logsumexp``, ``reduce_from_tp``,
``tp_argmax`` combine each rank's block), fused or not.
"""

import torch


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation and output from compute-dtype
    operands: bf16 operands straight into an f32 result on the card; on
    the CPU the operands are upcast first, as the JAX package does there."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, scale, block_v):
        b, s, d = x.shape
        v = w.shape[1]
        x2 = x.reshape(b * s, d)
        tg = targets.reshape(-1).long()
        n = x2.shape[0]
        dev = x.device
        m = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
        se = torch.zeros((n,), dtype=torch.float32, device=dev)
        tgt = torch.zeros((n,), dtype=torch.float32, device=dev)
        av = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
        ai = torch.zeros((n,), dtype=torch.int64, device=dev)
        for start in range(0, v, block_v):
            logits = _mm_f32(x2, w[:, start:start + block_v].to(x.dtype))
            if scale != 1.0:
                logits = logits * scale
            cm, ci = logits.max(-1)
            m_new = torch.maximum(m, cm)
            se = se * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(-1)
            m = m_new
            rel = tg - start
            inb = (rel >= 0) & (rel < logits.shape[1])
            got = logits.gather(1, rel.clamp(0, logits.shape[1] - 1)[:, None])
            tgt = torch.where(inb, got[:, 0], tgt)
            upd = cm > av
            av = torch.where(upd, cm, av)
            ai = torch.where(upd, start + ci, ai)
        logz = m + torch.log(se)
        ctx.save_for_backward(x, w, targets, logz)
        ctx.scale, ctx.block_v = scale, block_v
        ai = ai.to(torch.int32).reshape(b, s)
        av = av.reshape(b, s)
        ctx.mark_non_differentiable(ai, av)
        return logz.reshape(b, s), tgt.reshape(b, s), ai, av

    @staticmethod
    def backward(ctx, g_logz, g_tgt, _g_argmax, _g_max):
        x, w, targets, logz = ctx.saved_tensors
        scale, block_v = ctx.scale, ctx.block_v
        b, s, d = x.shape
        v = w.shape[1]
        x2 = x.reshape(b * s, d)
        tg = targets.reshape(-1).long()
        n = x2.shape[0]
        g_logz = (torch.zeros_like(logz) if g_logz is None
                  else g_logz.reshape(n).float())
        g_tgt = (torch.zeros_like(logz) if g_tgt is None
                 else g_tgt.reshape(n).float())
        dx = torch.zeros((n, d), dtype=torch.float32, device=x.device)
        dw = torch.empty((d, v), dtype=torch.float32, device=x.device)
        for start in range(0, v, block_v):
            w_c = w[:, start:start + block_v].to(x.dtype)
            logits = _mm_f32(x2, w_c)
            if scale != 1.0:
                logits = logits * scale
            bw = logits.shape[1]
            dlog = g_logz[:, None] * torch.exp(logits - logz[:, None])
            rel = tg - start
            inb = (rel >= 0) & (rel < bw)
            dlog.scatter_add_(1, rel.clamp(0, bw - 1)[:, None],
                              torch.where(inb, g_tgt, 0.0)[:, None])
            dlog_c = dlog.to(x.dtype)  # the compute dtype, as the forward
            dx += scale * _mm_f32(dlog_c, w_c.t())
            dw[:, start:start + bw] = scale * _mm_f32(x2.t(), dlog_c)
        return (dx.to(x.dtype).reshape(b, s, d), dw.to(w.dtype), None, None,
                None)


def fused_linear_ce(x, w, targets, scale: float = 1.0, block_v: int = 4096):
    """``(logz [B, S] f32, tgt_logit [B, S] f32, argmax [B, S] int32)`` of
    ``scale · (x @ w)`` without the logits. ``x`` ``[B, S, D]`` (the
    products run in its dtype with f32 accumulation), ``w`` ``[D, V]``
    (pass ``lm_head.weight.t()`` or ``embed.t()``; the gradient reaches
    the parameter through the view), ``targets`` ``[B, S]`` ids in
    ``[0, V)``. NLL is ``logz − tgt_logit``. Differentiable in x and w."""
    return _FusedCE.apply(x, w, targets, float(scale), int(block_v))[:3]


def vocab_parallel_ce(x, w, targets, scale: float, block_v: int, start: int,
                      mesh, fused: bool = True):
    """``fused_linear_ce``'s ``(logz, tgt_logit, argmax)`` over the whole
    vocab when this tp rank holds the vocab block ``[start, start + V_l)``
    of the head, ``w`` ``[D, V_l]``, and ``x`` is the same on every tp
    rank: each rank's partial logz, target logit and maximum (over its
    block, fused or from its f32 logits) meet over tp: logz as a
    logsumexp of the partials, the target logit from the rank that owns
    the target (the others add 0), the argmax as the first global
    maximum. The JAX step takes its unfused path under tp; either path
    here computes the same function."""
    from dlrover_tpu_torch.parallel.collectives import (
        reduce_from_tp,
        tp_argmax,
        tp_logsumexp,
    )

    rel = targets.long() - start  # outside [0, V_l): another rank's
    if fused:
        logz, tgt, amax, amax_v = _FusedCE.apply(x, w, rel, float(scale),
                                                 int(block_v))
    else:
        b, s, d = x.shape
        logits = _mm_f32(x.reshape(b * s, d), w.to(x.dtype)).reshape(b, s, -1)
        if scale != 1.0:
            logits = logits * scale
        vl = logits.shape[-1]
        logz = torch.logsumexp(logits, dim=-1)
        inb = (rel >= 0) & (rel < vl)
        got = logits.gather(-1, rel.clamp(0, vl - 1)[..., None])[..., 0]
        tgt = torch.where(inb, got, torch.zeros_like(got))
        amax = logits.detach().argmax(-1)
        amax_v = logits.detach().gather(-1, amax[..., None])[..., 0]
    return (tp_logsumexp(logz, mesh), reduce_from_tp(tgt, mesh),
            tp_argmax(amax_v, amax.long() + start, mesh))
