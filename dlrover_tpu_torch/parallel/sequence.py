"""Sequence (context) parallelism: Ulysses all-to-all and ring attention.

Port of ``dlrover_tpu/parallel/sequence.py``. The JAX functions take
global arrays sharded over the mesh and run their bodies in a
``shard_map``; here each rank calls them with its own block, ``[B_l,
S_l, H, D]`` (its rows of the batch over dp and fsdp, its sp sequence
block, and under tp the heads its ``decoder.TpPlan`` gives it), and
the collectives of ``parallel/collectives.py`` run over its sp group.
As in the JAX ``shard_map`` specs, heads stay cut over tp only when tp
divides both the query and the KV head counts (``head_axis``, the JAX
``_head_axis``): contiguous head blocks then keep each query head with
its KV group. Otherwise every tp rank attends over all heads.

- ``ulysses_attention``: an all-to-all turns ``[B, S/sp, H, D]`` into
  ``[B, S, H/sp, D]`` (the full sequence, a share of the heads), the
  inner attention (by default ``mha_reference``; the decoder gives the
  flash kernels) runs at the true global positions, and the inverse
  all-to-all brings the sequence block back.
- ``ring_attention``: k/v blocks travel the sp ring (``ring_shift``) for
  sp steps while the local q merges each block's normalized partial
  attention ``(out, lse)`` by ``logaddexp``. Each block runs
  ``flash_attention_with_lse`` (the CUDA kernels on the card, their plain
  versions on the CPU) with K/V at the KV head count. Block positions
  are host ints (``q_off = rank·S_l``, ``k_off = src·S_l``), so the
  block's case (``block_case``: dense, diagonal, window-partial,
  prefix-only, empty) is chosen on the host, where JAX uses
  ``lax.switch``; an empty block launches nothing. The window-partial
  and prefix-only blocks pass their offsets to the kernels. Each step's
  block attention and merge run under ``torch.utils.checkpoint`` (the
  JAX scan body is ``jax.checkpoint``-ed), the ring shifts outside it.
  Every received block is tied to the output (``_KeepInGraph``), so
  every rank runs every shift's backward (an exchange with its
  neighbors), whichever of its blocks were empty.
"""

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.ops.attention import NEG_INF, _repeat_kv, mha_reference
from dlrover_tpu_torch.ops.flash_attention import flash_attention_with_lse
from dlrover_tpu_torch.parallel.collectives import all_to_all, ring_shift

#: the block cases of ``block_case``
DENSE, DIAGONAL, WINDOW_PARTIAL, PREFIX_ONLY, EMPTY = (
    "dense", "diagonal", "window_partial", "prefix_only", "empty")
#: prefix_only's q offset: kills the causal term for every pair, leaving
#: the prefix mask
PREFIX_ONLY_Q_OFF = -(1 << 30)


def head_axis(mesh_shape, n_head: int, n_kv: int) -> Optional[str]:
    """``"tp"`` when heads stay cut over tp inside the sequence paths (tp
    above 1 and dividing both ``n_head`` and ``n_kv``), else None: every
    tp rank attends over all heads. The JAX ``_head_axis``."""
    tp = mesh_shape.get("tp", 1)
    if tp > 1 and n_head % tp == 0 and n_kv % tp == 0:
        return "tp"
    return None


def _match_heads(q, k, v):
    """GQA: repeat k/v heads up to q's head count."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = _repeat_kv(k, rep)
        v = _repeat_kv(v, rep)
    return k, v


def _check_masks(causal, prefix_len, window, ring=False):
    if prefix_len is not None and not causal:
        raise ValueError("prefix_len requires causal=True")
    if window:
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        if not causal:
            raise ValueError("window requires causal=True")
        if ring and prefix_len is not None:
            raise ValueError("window and prefix_len are mutually exclusive")


# ---------------------------------------------------------------------------
# Ulysses (all-to-all) sequence parallelism
# ---------------------------------------------------------------------------


def ulysses_attention(q, k, v, mesh, *, causal: bool = True,
                      axis: str = "sp", attn_fn=None, prefix_len=None,
                      window: int = 0):
    """Exact attention of this rank's sequence block ``[B, S/sp, H, D]``
    (k/v ``[B, S/sp, Hkv, D]``) over the whole sequence of its sp group.
    ``prefix_len`` ``[B]`` (global positions) and ``window`` reach the
    inner ``attn_fn`` unchanged: it sees the full sequence."""
    _check_masks(causal, prefix_len, window)
    attn_fn = attn_fn or functools.partial(mha_reference, causal=causal)

    def call(q, k, v):
        kw = {}
        if prefix_len is not None:
            kw["prefix_len"] = prefix_len
        if window:
            kw["window"] = window
        return attn_fn(q, k, v, **kw)

    sp = mesh.shape[axis]
    if sp == 1:
        return call(q, k, v)
    # GQA stays at Hkv heads unless sp cannot split them: decided from
    # this rank's (under tp, tp-local) KV head count, as JAX does
    if k.shape[2] % sp:
        k, v = _match_heads(q, k, v)
    qh, kh, vh = (all_to_all(x, mesh, 2, 1, axis) for x in (q, k, v))
    return all_to_all(call(qh, kh, vh), mesh, 1, 2, axis)


# ---------------------------------------------------------------------------
# Ring attention (blockwise context parallelism over ring shifts)
# ---------------------------------------------------------------------------


def block_case(q_off: int, k_off: int, sq: int, sk: int, causal: bool,
               window: int = 0, prefix=None) -> str:
    """The case of one ring block, ``_block_softmax_flash``'s: the k/v
    block at ``k_off`` against the q block at ``q_off``. ``prefix``: the
    global prefix lengths (host ints), or None."""
    if not causal:
        return DENSE
    if window:
        if k_off > q_off:
            return EMPTY
        if k_off == q_off:
            return DIAGONAL
        dist = q_off - k_off
        if dist - (sk - 1) >= window:
            return EMPTY
        if dist + sq - 1 < window:
            return DENSE
        return WINDOW_PARTIAL
    if prefix is not None:
        if k_off < q_off:
            return DENSE
        if k_off == q_off:
            return DIAGONAL
        reach = max(min(max(int(p) - k_off, 0), sk) for p in prefix) > 0
        return PREFIX_ONLY if reach else EMPTY
    if k_off == q_off:
        return DIAGONAL
    return DENSE if k_off < q_off else EMPTY


def _block_softmax(case, q, k, v, scale, q_off, k_off, window, prefix,
                   local_pref):
    """``(out [B, Sq, H, D] f32 normalized within the block, lse [B, H,
    Sq] f32)`` of one non-empty block; a row that sees no key of it gets
    ``(0, NEG_INF)``, the contract the merge's guards read."""
    kw = dict(softmax_scale=scale)
    seen = None
    if case == DENSE:
        out, lse = flash_attention_with_lse(q, k, v, causal=False, **kw)
    elif case == DIAGONAL:
        # both blocks at one global offset: block-local causal (+ window)
        # with the block's slice of the prefix
        out, lse = flash_attention_with_lse(
            q, k, v, causal=True, window=window,
            prefix_len=None if prefix is None else local_pref, **kw)
    elif case == WINDOW_PARTIAL:
        out, lse = flash_attention_with_lse(
            q, k, v, causal=True, window=window, offsets=(q_off, k_off),
            **kw)
        # row i's window reaches key k_off + sk - 1 iff i <= last
        last = k_off + k.shape[1] - 1 - q_off + window - 1
        seen = (torch.arange(q.shape[1], device=q.device) <= last)[None]
    else:  # PREFIX_ONLY
        # a hugely negative q offset kills the causal term: what is left
        # is the block's keys inside the prefix, the same for every row
        out, lse = flash_attention_with_lse(
            q, k, v, causal=True, prefix_len=local_pref,
            offsets=(PREFIX_ONLY_Q_OFF, 0), **kw)
        seen = (local_pref > 0)[:, None]
    out = out.float()
    if seen is not None:
        rows = seen.expand(q.shape[0], q.shape[1])
        out = torch.where(rows[:, :, None, None], out, 0.0)
        lse = torch.where(rows[:, None, :], lse, NEG_INF)
    return out, lse


def _merge(acc, lse_run, out_blk, lse_blk):
    """Two normalized partials merged: ``logaddexp`` on the lse, each out
    rescaled, a NEG_INF side weighing 0."""
    lse_new = torch.logaddexp(lse_run, lse_blk)
    alpha_run = torch.where(lse_run <= NEG_INF, 0.0,
                            torch.exp(lse_run - lse_new))
    alpha_blk = torch.where(lse_blk <= NEG_INF, 0.0,
                            torch.exp(lse_blk - lse_new))
    acc = (acc * alpha_run.transpose(1, 2)[..., None]
           + out_blk * alpha_blk.transpose(1, 2)[..., None])
    return acc, lse_new


class _KeepInGraph(torch.autograd.Function):
    """Returns ``x`` and gives each other input a zero gradient. The ring
    ties every k/v block it received to its output through this, so the
    backward of every ring shift runs on every rank: a shift's backward is
    an exchange with both neighbors, and a rank whose blocks past some
    step are all empty would otherwise skip it and leave them waiting."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.metas = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(shape, dtype=dtype, device=dev)
                            for shape, dtype, dev in ctx.metas)


def _ring_step(case, scale, q_off, k_off, window, prefix, q, k_blk, v_blk,
               acc, lse_run, local_pref):
    out_blk, lse_blk = _block_softmax(case, q, k_blk, v_blk, scale, q_off,
                                      k_off, window, prefix, local_pref)
    return _merge(acc, lse_run, out_blk, lse_blk)


def ring_attention(q, k, v, mesh, *, causal: bool = True, axis: str = "sp",
                   softmax_scale: Optional[float] = None, prefix_len=None,
                   window: int = 0):
    """Exact attention of this rank's sequence block over its sp group's
    whole sequence via a k/v ring: q ``[B, S/sp, H, D]``, k/v ``[B, S/sp,
    Hkv, D]`` (equal blocks, block c of the sequence on sp coordinate c;
    the JAX ``block_q``/``block_k`` are the Pallas tiles, which the CUDA
    kernels choose by themselves). ``prefix_len`` ``[B]``
    in global positions is read to the host once a call (it picks the
    blocks' cases). At sp 1: ``mha_reference``."""
    _check_masks(causal, prefix_len, window, ring=True)
    sp = mesh.shape[axis]
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    if sp == 1:
        return mha_reference(q, k, v, causal=causal, softmax_scale=scale,
                             prefix_len=prefix_len, window=window)
    rank = mesh.coord(axis)
    b, sq, h, d = q.shape
    q_off = rank * sq
    prefix = (None if prefix_len is None
              else [int(p) for p in prefix_len.reshape(-1).tolist()])
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                     device=q.device)
    k_blk, v_blk = k, v
    received = []
    for step in range(sp):
        src = (rank - step) % sp
        k_off = src * sq
        case = block_case(q_off, k_off, sq, k_blk.shape[1], causal, window,
                          prefix)
        if case != EMPTY:
            local_pref = None
            if prefix is not None:
                local_pref = torch.tensor(
                    [min(max(p - k_off, 0), k_blk.shape[1]) for p in prefix],
                    dtype=torch.int32, device=q.device)
            fn = functools.partial(_ring_step, case, scale, q_off, k_off,
                                   window, prefix)
            acc, lse = checkpoint(fn, q, k_blk, v_blk, acc, lse, local_pref,
                                  use_reentrant=False)
        if step + 1 < sp:
            k_blk, v_blk = ring_shift((k_blk, v_blk), mesh, axis)
            received += [k_blk, v_blk]
    return _KeepInGraph.apply(acc, *received).to(q.dtype)
