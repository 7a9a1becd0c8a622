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
  returning a new tensor; :func:`copy_to_axis` and
  :func:`reduce_from_axis` are Megatron's f and g (an all-reduce in the
  backward or in the forward only), the training path's tensor-parallel
  collectives;
- :func:`all_gather`: JAX's tiled ``all_gather`` (every index's tensor
  concatenated along one dimension, in index order);
  :func:`all_gather_grad` is the same with a gradient whose backward takes
  this index's slice of the cotangent (the vocab-sharded head of the
  training path: its cotangent is replicated);
- :func:`send`, :func:`recv` and :func:`broadcast`: point-to-point
  transfers and a broadcast from one index (the pipeline's stage-to-stage
  activations, ``ppermute`` with an open chain, and its logits);
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


def all_gather(x: torch.Tensor, axis, dim: int = -1) -> torch.Tensor:
    """JAX's ``all_gather(x, axis, axis=dim, tiled=True)``: the tensors of
    every index along the axis, concatenated along ``dim`` in index order
    (equal shapes on every rank)."""
    if axis.size == 1:
        return x
    buf = _send_form(x, axis)
    parts = [_empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(parts, buf, group=axis.group)
    return torch.cat([_back(p, x) for p in parts], dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


def all_gather_grad(x: torch.Tensor, axis, dim: int = -1) -> torch.Tensor:
    """:func:`all_gather` with a gradient: the backward is this index's
    slice of the cotangent, which every index holds whole (JAX's
    ``_gather_vocab``)."""
    return _AllGather.apply(x, axis, dim)


class _SumBackward(torch.autograd.Function):
    """Megatron's f: the identity forward, a sum over the axis backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _SumForward(torch.autograd.Function):
    """Megatron's g: a sum over the axis forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_axis(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's f on ``axis``: ``x`` forward, its cotangent summed over
    the axis backward (JAX ``models/train._f``)."""
    return x if axis is None else _SumBackward.apply(x, axis)


def reduce_from_axis(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's g on ``axis``: the sum over the axis forward, the
    cotangent as it is backward (JAX ``models/train._g``)."""
    return x if axis is None else _SumForward.apply(x, axis)


def _recv_buffer(shape, dtype, device, axis) -> torch.Tensor:
    if device.type == "cuda" and axis.backend == "gloo":
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=device)


def send(x: torch.Tensor, axis, index: int) -> None:
    """Send ``x`` to ``index`` along the axis (blocking)."""
    dist.send(_send_form(x, axis), axis.rank_at(index), group=axis.group)


def recv(shape, dtype: torch.dtype, device: torch.device, axis, index: int) -> torch.Tensor:
    """Receive a tensor of ``shape`` and ``dtype`` from ``index`` along the
    axis, on ``device`` (blocking)."""
    buf = _recv_buffer(shape, dtype, device, axis)
    dist.recv(buf, axis.rank_at(index), group=axis.group)
    return _back(buf, torch.empty(0, device=device))


def broadcast(x: torch.Tensor | None, shape, dtype: torch.dtype, device: torch.device, axis,
              index: int) -> torch.Tensor:
    """Index ``index``'s tensor ``x`` on every rank of the axis (the others
    pass None and the shape and dtype to expect): the same bytes everywhere."""
    if axis.index == index:
        buf = _send_form(x, axis)
        if buf.data_ptr() == x.data_ptr():
            buf = buf.clone()
    else:
        buf = _recv_buffer(shape, dtype, device, axis)
    dist.broadcast(buf, axis.rank_at(index), group=axis.group)
    return _back(buf, torch.empty(0, device=device))


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
