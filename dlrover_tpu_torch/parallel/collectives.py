"""The collectives of sequence parallelism, with autograd.

Port of the ``jax.lax`` collectives ``parallel/sequence.py`` uses inside
its ``shard_map``s: ``ppermute`` (the ring's k/v rotation) and the tiled
``all_to_all`` (Ulysses' sequence ↔ head exchange). Each is an autograd
function whose backward is its transpose: the ring shift sends the
gradients back the way the values came, the all-to-all runs the inverse
exchange.

Transport. On an NCCL group the tensors go as they are. On a gloo group
(the caller asked for it: several ranks that share one card, or the CPU)
a CUDA tensor is staged through a page-locked host buffer, since gloo
moves host memory: ``dist.batch_isend_irecv`` and
``dist.all_to_all_single`` run on the host copies, and the results come
back to the card. Nothing here picks a backend.
"""

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
