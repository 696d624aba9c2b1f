"""The collectives of sequence, fully sharded and tensor parallelism,
with autograd.

Port of the ``jax.lax`` collectives ``parallel/sequence.py`` uses inside
its ``shard_map``s: ``ppermute`` (the ring's k/v rotation) and the tiled
``all_to_all`` (Ulysses' sequence ↔ head exchange). Each is an autograd
function whose backward is its transpose: the ring shift sends the
gradients back the way the values came, the all-to-all runs the inverse
exchange.

And the collectives GSPMD inserts for the sharded layouts (the JAX
decoder under ``DEFAULT_RULES``), made explicit:

- ``fsdp_gather``: ZeRO-3 gather-on-use of a weight's fsdp-cut dim, cast
  to the compute dtype first (the same bits as JAX's cast after the
  gather, half the traffic); its backward reduce-scatters the f32
  gradient, a sum, since the fsdp ranks hold different rows;
- ``copy_to_tp`` / ``reduce_from_tp``: Megatron's f and g around a
  tensor-parallel block: the identity whose backward sums the input's
  gradient over tp, and the sum over tp of the row-parallel partials,
  whose backward is the identity (every tp rank holds the same loss, so
  the same output gradient);
- ``gather_from_tp``: an all-gather over tp whose backward slices this
  rank's block back out (not a reduce-scatter: the gradients that reach
  it are the same on every tp rank);
- ``gather_sum_tp``: an all-gather over tp whose backward
  reduce-scatters, for a block whose gathered whole each tp rank uses
  for a different share of its output (the q heads every tp rank
  attends over inside a sequence-parallel attention when tp does not
  divide the heads, as the JAX ``_head_axis`` leaves them);
- ``tp_reshard``: a dim cut over tp in one partition moved to another
  (uneven blocks allowed) by one all-to-all: the q columns of a rank's
  ``wq`` block to the whole heads it attends over, GSPMD's padded head
  blocks when tp does not divide the head count, and the attention's
  output back; its backward is the inverse move, each element's
  gradient back to its owner;
- ``tp_logsumexp``: logsumexp over the tp ranks' partial logsumexps (the
  vocab-parallel logz), and ``tp_argmax``: the first maximum over the
  whole vocab from each rank's maximum and its global index.

And ``all_to_all_rows``, the untiled all-to-all of ZeRO's quantized
gradient wires (``parallel/sharding.py``): row j of a rank's tensor to
rank j of the group.

Transport. On an NCCL group the tensors go as they are. On a gloo group
(the caller asked for it: several ranks that share one card, or the CPU)
a CUDA tensor is staged through a page-locked host buffer, since gloo
moves host memory: the point-to-point batches, all-to-alls, all-gathers,
reduce-scatters and all-reduces run on the host copies, and the results
come back to the card; ``all_to_all_rows`` moves its rows across a gloo
group as bytes (the same bits: an all-to-all does no arithmetic).
Nothing here picks a backend.
"""

import math
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def exchange(xs: Sequence[torch.Tensor], dst: int, src: int,
             group) -> List[torch.Tensor]:
    """Send each of ``xs`` to global rank ``dst`` and receive tensors of
    the same shapes from global rank ``src``, all in one batch of
    point-to-point ops (tensor i on tag i)."""
    xs = [x.contiguous() for x in xs]
    staged = _staged(group, xs[0])
    sends = [_host(x) for x in xs] if staged else xs
    recvs = [torch.empty(s.shape, dtype=s.dtype, device=s.device,
                         pin_memory=staged) for s in sends]
    ops = ([dist.P2POp(dist.isend, s, dst, group, tag=i)
            for i, s in enumerate(sends)]
           + [dist.P2POp(dist.irecv, r, src, group, tag=i)
              for i, r in enumerate(recvs)])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        recvs = [r.to(x.device) for r, x in zip(recvs, xs)]
    return recvs


class _RingShift(torch.autograd.Function):
    """``ppermute`` one step round the ring: to ``nxt``, from ``prv``."""

    @staticmethod
    def forward(ctx, ring, *xs):
        nxt, prv, group = ring
        ctx.ring = ring
        return tuple(exchange(xs, nxt, prv, group))

    @staticmethod
    def backward(ctx, *gs):
        nxt, prv, group = ctx.ring
        return (None,) + tuple(exchange(gs, prv, nxt, group))


def ring_shift(xs: Sequence[torch.Tensor], mesh, axis: str = "sp"
               ) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` moved to the next rank of this rank's ``axis`` ring
    (coordinate c → c + 1 mod n), as ``jax.lax.ppermute`` with the ring's
    permutation: this rank gets the previous rank's. Differentiable."""
    ranks = mesh.ranks(axis)
    c = mesh.coord(axis)
    ring = (ranks[(c + 1) % len(ranks)], ranks[(c - 1) % len(ranks)],
            mesh.group(axis))
    return _RingShift.apply(ring, *xs)


def _all_to_all(x: torch.Tensor, split: int, concat: int, group):
    n = dist.get_world_size(group)
    chunks = torch.stack(x.chunk(n, dim=split)).contiguous()
    staged = _staged(group, x)
    send = _host(chunks) if staged else chunks
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device,
                       pin_memory=staged)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    return torch.cat(recv.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group):
        ctx.args = (split, concat, group)
        return _all_to_all(x, split, concat, group)

    @staticmethod
    def backward(ctx, g):
        split, concat, group = ctx.args
        return _all_to_all(g, concat, split, group), None, None, None


def all_to_all(x: torch.Tensor, mesh, split_axis: int, concat_axis: int,
               axis: str = "sp") -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over this rank's ``axis`` group: ``x`` cut in n equal chunks along
    ``split_axis``, chunk j sent to coordinate j, the chunks received
    joined along ``concat_axis`` in coordinate order. Differentiable."""
    return _AllToAll.apply(x, split_axis, concat_axis, mesh.group(axis))


def all_to_all_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` of ``[n, ...]`` over a group of n ranks: row j goes to rank j
    of the group, and row i of the result came from rank i (one
    ``all_to_all_single``; ``jax.lax.all_to_all`` with ``split_axis =
    concat_axis = 0``)."""
    x = x.contiguous()
    gloo = dist.get_backend(group) == dist.Backend.GLOO
    # gloo takes some dtypes and not others (int16 not, on torch 2.x):
    # it moves every one as its bytes, which an all-to-all leaves as they
    # are
    words = x.view(torch.uint8) if gloo else x
    staged = _staged(group, words)
    send = _host(words) if staged else words
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device,
                       pin_memory=staged)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    return recv.view(x.dtype)


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` (the world by default) in place, through a
    page-locked host copy when a gloo group meets a CUDA tensor."""
    if _staged(group, t):
        buf = _host(t)
        dist.all_reduce(buf, group=group)
        t.copy_(buf)
    else:
        dist.all_reduce(t, group=group)
    return t


# ---------------------------------------------------------------------------
# fsdp and tp
# ---------------------------------------------------------------------------


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` joined along ``dim`` in rank order
    (one all-gather)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    staged = _staged(group, x)
    src = _host(x) if staged else x
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                      device=src.device, pin_memory=staged)
    dist.all_gather_into_tensor(out.view(-1), src.view(-1), group=group)
    if staged:
        out = out.to(x.device)
    return torch.cat(out.unbind(0), dim=dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of ``x``, of which this rank keeps block
    ``rank`` of ``n`` along ``dim`` (one reduce-scatter)."""
    n = dist.get_world_size(group)
    chunks = torch.stack(x.chunk(n, dim=dim)).contiguous()
    staged = _staged(group, x)
    src = _host(chunks) if staged else chunks
    out = torch.empty(src.shape[1:], dtype=x.dtype, device=src.device,
                      pin_memory=staged)
    dist.reduce_scatter_tensor(out.view(-1), src.view(-1), group=group)
    return out.to(x.device) if staged else out


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, dtype, group):
        ctx.args = (dim, group, w.dtype)
        return all_gather_dim(w.to(dtype), dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group, dtype = ctx.args
        return (reduce_scatter_dim(g.float(), dim, group).to(dtype), None,
                None, None)


def fsdp_gather(w: torch.Tensor, dim: int, dtype: torch.dtype, mesh
                ) -> torch.Tensor:
    """The whole of ``w``'s fsdp-cut ``dim`` in ``dtype`` (this rank's
    block cast, then gathered over its fsdp group); the backward
    reduce-scatters the f32 gradient to this rank's block, summed."""
    return _FsdpGather.apply(w, dim, dtype, mesh.group("fsdp"))


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's f: ``x`` as it is; the backward sums its gradient over
    tp (each tp rank's block used only its share of ``x``'s uses)."""
    return _CopyToTp.apply(x, mesh.group("tp"))


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's g: the sum over tp of ``x`` (a row-parallel partial);
    the backward passes the gradient through."""
    return _ReduceFromTp.apply(x, mesh.group("tp"))


class _GatherFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.args = (dim, dist.get_rank(group), x.shape[dim])
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, rank, size = ctx.args
        return g.narrow(dim, rank * size, size), None, None


def gather_from_tp(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Every tp rank's block of ``x`` joined along ``dim``; the backward
    keeps this rank's block of the gradient."""
    return _GatherFromTp.apply(x, dim, mesh.group("tp"))


def gather_sum_tp(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Every tp rank's block of ``x`` joined along ``dim``; the backward
    sums the gradient over tp and keeps this rank's block of it (each
    rank's use of the whole reaches other ranks' blocks)."""
    return _FsdpGather.apply(x, dim, x.dtype, mesh.group("tp"))


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> int:
    return max(0, min(a[1], b[1]) - max(a[0], b[0]))


def _reshard(x: torch.Tensor, src, dst, group) -> torch.Tensor:
    """``x``, this rank's block ``src[r]`` of the last dim, as its block
    ``dst[r]`` (both partitions in rank order over the same range): one
    all-to-all with uneven splits, the last dim moved to the front."""
    r = dist.get_rank(group)
    lead = x.shape[:-1]
    (lo, hi), (dlo, dhi) = src[r], dst[r]
    send = x.reshape(math.prod(lead), hi - lo).t().contiguous()
    sends = [_overlap(src[r], d) for d in dst]
    recvs = [_overlap(s, dst[r]) for s in src]
    gloo = dist.get_backend(group) == dist.Backend.GLOO
    # gloo moves rows of any dtype as bytes, as all_to_all_rows does
    words = send.view(torch.uint8) if gloo else send
    staged = _staged(group, words)
    buf = _host(words) if staged else words
    recv = torch.empty((dhi - dlo,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                       device=buf.device, pin_memory=staged)
    dist.all_to_all_single(recv, buf, recvs, sends, group=group)
    if staged:
        recv = recv.to(x.device)
    return recv.view(x.dtype).t().reshape(*lead, dhi - dlo)


class _TpReshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dst, group):
        ctx.args = (src, dst, group)
        return _reshard(x, src, dst, group)

    @staticmethod
    def backward(ctx, g):
        src, dst, group = ctx.args
        return _reshard(g, dst, src, group), None, None, None


def tp_reshard(x: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """``x``'s last dim, this tp rank's block ``src[r]`` (``(start,
    stop)`` a rank, in rank order, covering one range) of a dim cut over
    tp, as its block ``dst[r]`` of another partition of the same range:
    each rank sends every other the part of its block that falls in that
    rank's new one. The backward moves the gradient back, ``dst`` to
    ``src``."""
    return _TpReshard.apply(x, tuple(src), tuple(dst), mesh.group("tp"))


class _TpLogSumExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lse, group):
        out = torch.logsumexp(all_gather_dim(lse[None], 0, group), dim=0)
        ctx.save_for_backward(lse, out)
        return out

    @staticmethod
    def backward(ctx, g):
        lse, out = ctx.saved_tensors
        return g * torch.exp(lse - out), None


def tp_logsumexp(lse: torch.Tensor, mesh) -> torch.Tensor:
    """``log Σ_r exp(lse_r)`` over the tp ranks' ``lse`` (the logsumexp
    of each rank's vocab block): the logsumexp over the whole vocab."""
    return _TpLogSumExp.apply(lse, mesh.group("tp"))


@torch.no_grad()
def tp_argmax(value: torch.Tensor, index: torch.Tensor, mesh
              ) -> torch.Tensor:
    """The global index of the largest ``value`` over the tp ranks (each
    rank's maximum over its vocab block and that maximum's global index):
    on a tie the lowest index, as ``jnp.argmax`` over the whole vocab."""
    group = mesh.group("tp")
    values = all_gather_dim(value[None].float(), 0, group)
    indices = all_gather_dim(index[None].long(), 0, group)
    best = values.argmax(0, keepdim=True)
    return indices.gather(0, best)[0].to(index.dtype)
