"""Collectives over one mesh axis — the port's stand-in for
``jax.lax.ppermute``, ``psum``, ``pmax`` and ``all_to_all`` inside a
``shard_map``.

Each function takes an :class:`parallel.mesh.Axis` and runs on its group:

- :func:`start_ring_shift`: every rank sends its tensors to the next rank
  along the axis, ``(index + 1) mod n``, and receives the previous one's
  (``ppermute`` with ``[(i, (i + 1) % n)]``), through
  ``torch.distributed.batch_isend_irecv``; it returns at once, and
  ``.wait()`` gives the received tensors, so that a caller can issue the
  next step's rotation before the kernel of the step in hand;
- :func:`all_reduce`: ``psum`` (``op="sum"``) or ``pmax`` (``op="max"``),
  returning a new tensor;
- :func:`all_to_all`: JAX's tiled all-to-all, ``split_dim`` cut into n
  chunks, chunk j sent to index j, the received chunks concatenated along
  ``concat_dim`` in index order; :func:`all_to_all_grad` is the same with a
  gradient (the transpose of a tiled all-to-all is the all-to-all with the
  two dimensions swapped), for Ulysses under autograd.

The group's backend decides how a CUDA tensor travels: NCCL takes it as it
is; gloo takes CPU tensors only (its ``send`` / ``recv`` do not even check
the device), so under gloo a CUDA tensor is copied to page-locked host
memory, sent, and the result copied back. A failure never switches the
path. ``host_bytes`` counts the bytes those copies move, both ways.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

host_bytes = 0  # bytes copied between a card and the host for a gloo group, both ways

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _via_host(x: torch.Tensor, axis) -> bool:
    return x.is_cuda and axis.backend == "gloo"


def _empty_like(x: torch.Tensor) -> torch.Tensor:
    """``torch.empty_like`` that keeps a host tensor page-locked: the card
    copies to and from page-locked memory several times faster than to
    pageable memory."""
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True) if x.is_pinned() else torch.empty_like(x)


def _send_form(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` as the group's backend takes it: contiguous, and for gloo
    copied to page-locked host memory."""
    global host_bytes
    x = x.contiguous()
    if _via_host(x, axis):
        host_bytes += x.numel() * x.element_size()
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
    return x


def _back(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received host tensor back on ``like``'s device."""
    global host_bytes
    if like.is_cuda and not x.is_cuda:
        host_bytes += x.numel() * x.element_size()
        return x.to(like.device)
    return x


class PendingShift:
    """A ring shift in flight; :meth:`wait` returns the received tensors on
    the senders' devices."""

    def __init__(self, reqs, sent, received, like):
        self._reqs, self._sent, self._received, self._like = reqs, sent, received, like

    def wait(self) -> list[torch.Tensor]:
        for r in self._reqs:
            r.wait()
        out = [_back(r, like) for r, like in zip(self._received, self._like)]
        self._reqs = self._sent = self._received = None
        return out


def start_ring_shift(tensors: list[torch.Tensor], axis) -> PendingShift:
    """Send each tensor to index ``(i + 1) mod n`` of the axis and receive
    as many from ``(i - 1) mod n``, without waiting."""
    if axis.size == 1:  # the ring of one rank: every tensor comes back to it
        return PendingShift([], [], list(tensors), tensors)
    sent = [_send_form(t, axis) for t in tensors]
    received = [_empty_like(s) for s in sent]
    nxt, prv = axis.rank_at(axis.index + 1), axis.rank_at(axis.index - 1)
    ops = [dist.P2POp(dist.isend, s, nxt, axis.group) for s in sent]
    ops += [dist.P2POp(dist.irecv, r, prv, axis.group) for r in received]
    return PendingShift(dist.batch_isend_irecv(ops), sent, received, tensors)


def ring_shift(tensors: list[torch.Tensor], axis) -> list[torch.Tensor]:
    """:func:`start_ring_shift`, waited for."""
    return start_ring_shift(tensors, axis).wait()


def all_reduce(x: torch.Tensor, axis, op: str = "sum") -> torch.Tensor:
    """The sum or the max of ``x`` over the axis, as a new tensor."""
    buf = _send_form(x, axis)
    if buf.data_ptr() == x.data_ptr():  # reduced in place: not into the caller's tensor
        buf = buf.clone()
    dist.all_reduce(buf, op=_OPS[op], group=axis.group)
    return _back(buf, x)


def all_to_all(x: torch.Tensor, axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    """JAX's ``all_to_all(x, axis, split_axis, concat_axis, tiled=True)``."""
    n = axis.size
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of {tuple(x.shape)} is not divisible by {n}")
    buf = _send_form(torch.stack(x.chunk(n, dim=split_dim)), axis)
    out = _empty_like(buf)
    dist.all_to_all_single(out, buf, group=axis.group)
    return torch.cat(_back(out, x).unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.axis, ctx.dims = axis, (split_dim, concat_dim)
        return all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return all_to_all(g, ctx.axis, concat_dim, split_dim), None, None, None


def all_to_all_grad(x: torch.Tensor, axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    """:func:`all_to_all` with a gradient: its backward is the all-to-all
    with ``split_dim`` and ``concat_dim`` swapped."""
    return _AllToAll.apply(x, axis, split_dim, concat_dim)
