"""Sharded training — twin of the JAX ``parallel/train.py``: the
context-parallel (× data-parallel) step and the tensor-parallel ones.

:func:`make_cp_train_step` shards each sequence over the ``seq`` axis (and,
optionally, the batch rows over a ``data`` axis): each rank runs
``models.train.loss_tokens`` on its chunk with ``seq_axis_name``, whose
attention is the ring (``parallel/ring.py``: K5 with ``kv_offset`` forward,
K12 backward), so that no rank holds a whole sequence's activations. The
parameters and the optimizer state stay replicated: CP shards activations,
not weights. The loss and the gradients are averaged over every activation
axis in the gradients' own dtype, as JAX's per-leaf ``pmean`` (a sum
all-reduce of one flat buffer a dtype and axis, divided by its size; equal
chunks make that the global mean), and every rank then applies
the same update in place. The optimizer is the port's SGD with momentum 0.9
(``models.train.sgd_update_``, as ``models.train.train_step``) where JAX
takes an optax optimizer; :func:`init_opt_state` gives its zero momentum.

The tensor-parallel builders (JAX :36-115, :240-301) keep the params in
the serving layouts (``parallel.tp.shard_params``: each rank its shard, so
a model trained on the mesh serves on it without resharding). Each rank
runs ``models.train`` with ``axis_name`` on its batch rows (Megatron's f
and g make the backward exact, and leave the replicated parameters'
gradients whole and equal over ``model``); the loss and the gradients are
then averaged over ``data`` (and ``seq``) only, in the gradients' own
dtype: :func:`make_tp_dp_value_and_grad`, :func:`make_tp_dp_train_step`
(TP x DP) and :func:`make_tp_cp_train_step` (TP x CP x optional DP, the
ring rotating head-sharded KV chunks). An MoE model trains expert-parallel
under them as it is: each rank holds whole experts (``tp.shard_params``),
routes over all of them with the replicated router, and Megatron's f on
the router weight and g after the MoE make its gradients exact
(``models.train._moe_mlp_train``).
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.models.train import (loss_fn, loss_tokens, sgd_update_, tree_leaves, tree_map,
                                                       tree_unflatten, value_and_grad)
from starflashattention_tpu_torch.parallel import comm
from starflashattention_tpu_torch.runtime.params import ModelConfig

SEQ = "seq"
DATA, MODEL = "data", "model"


def make_tp_dp_value_and_grad(mesh, cfg: ModelConfig, *, use_flash: bool = True, remat: bool = True,
                              grad_accum: int = 1):
    """``(vg, vg)`` with ``vg(params, batch, cos, sin) -> (loss, grads)``
    over the ``(data, model)`` mesh (JAX returns its jitted and unjitted
    forms; the port has one). ``params`` is this rank's shard
    (``tp.shard_params``, dense, the training dtype); ``batch`` the GLOBAL
    (B, S+1) token batch, the same on every rank, B divisible by the data
    axis: each rank takes its data shard's rows. ``loss`` is the global
    batch mean; ``grads`` are shaped like this rank's ``params``."""
    from starflashattention_tpu_torch.parallel import tp

    tp._check(cfg, mesh)
    shard_cfg = tp._shard_cfg(cfg, mesh)
    model, data = mesh.axis(MODEL), mesh.axes.get(DATA)

    def one(params, batch, cos, sin):
        return value_and_grad(lambda p: loss_fn(p, batch, shard_cfg, cos, sin, use_flash=use_flash,
                                                remat=remat, axis_name=model), params)

    def vg(params, batch, cos, sin):
        batch = _local_rows(torch.as_tensor(batch, device=mesh.device), data, 0)
        if grad_accum > 1:
            loss, grads = _accumulate(lambda p, b: one(p, b, cos, sin), grad_accum)(params, batch)
        else:
            loss, grads = one(params, batch, cos, sin)
        if data is not None:  # equal data shards: the global mean is the mean of the shards' means
            loss, grads = _mean_over(loss, grads, data)
        return loss, grads

    return vg, vg


def make_tp_dp_train_step(mesh, cfg: ModelConfig, lr: float, *, use_flash: bool = True, remat: bool = True,
                          grad_accum: int = 1):
    """``step(params, opt_state, batch, cos, sin) -> (params, opt_state,
    loss)``: one SGD-with-momentum step at ``lr`` (where JAX takes an optax
    optimizer) over the ``(data, model)`` mesh, ``params`` and
    ``opt_state`` this rank's shards, updated IN PLACE."""
    vg, _ = make_tp_dp_value_and_grad(mesh, cfg, use_flash=use_flash, remat=remat, grad_accum=grad_accum)

    def step(params, opt_state, batch, cos, sin):
        loss, grads = vg(params, batch, cos, sin)
        sgd_update_(params, opt_state, grads, lr)
        return params, opt_state, loss

    return step


def make_tp_cp_train_step(mesh, cfg: ModelConfig, lr: float, *, seq_axis: str = SEQ,
                          data_axis: str | None = None, remat: bool = True):
    """TP (``model``) x context parallelism (``seq_axis``, the ring) x
    optional data parallelism: ``step(params, opt_state, batch, cos, sin)
    -> (params, opt_state, loss)`` with this rank's TP shard of the params
    (replicated over ``seq`` and ``data``) and the GLOBAL (B, S+1) batch,
    cut as :func:`make_cp_train_step` cuts it. The gradients are averaged
    over the seq and data axes; the model axis is Megatron's f and g."""
    from starflashattention_tpu_torch.parallel import tp

    tp._check(cfg, mesh)
    shard_cfg = tp._shard_cfg(cfg, mesh)
    model, seq = mesh.axis(MODEL), mesh.axis(seq_axis)
    data = None if data_axis is None else mesh.axis(data_axis)
    axes = [a for a in (data, seq) if a is not None]

    def step(params, opt_state, batch, cos, sin):
        batch = torch.as_tensor(batch, device=mesh.device)
        inp, tgt = batch[:, :-1], batch[:, 1:]
        inp, tgt = (_local_rows(_local_rows(x, data, 0), seq, 1) for x in (inp, tgt))
        loss, grads = value_and_grad(
            lambda p: loss_tokens(p, inp, tgt, shard_cfg, cos, sin, use_flash=True, remat=remat,
                                  axis_name=model, seq_axis_name=seq), params)
        for axis in axes:
            loss, grads = _mean_over(loss, grads, axis)
        sgd_update_(params, opt_state, grads, lr)
        return params, opt_state, loss

    return step


def init_opt_state(params):
    """The SGD-with-momentum state: zeros shaped and typed like ``params``
    (``models.train.train_step``'s momentum)."""
    return tree_map(torch.zeros_like, params)


def _accumulate(value_and_grad_fn, accum_steps: int):
    """Microbatch gradient accumulation: split the batch's LEADING axis
    into ``accum_steps`` equal microbatches, run the gradient on each, and
    average in fp32 — the full batch's math (a mean of equal microbatch
    means is the batch mean), with the activations of one microbatch alive
    at a time."""

    def fn(params, *batch_args):
        if batch_args[0].shape[0] % accum_steps:
            raise ValueError(f"grad_accum {accum_steps} does not divide the local batch of "
                             f"{batch_args[0].shape[0]} rows")
        loss_acc, grads_acc = None, None
        for mb in zip(*(a.chunk(accum_steps, dim=0) for a in batch_args)):
            loss, grads = value_and_grad_fn(params, *mb)
            leaves = [g.float() for g in tree_leaves(grads)]
            if grads_acc is None:
                loss_acc, grads_acc = loss.float(), leaves
            else:
                loss_acc = loss_acc + loss.float()
                for acc, g in zip(grads_acc, leaves):
                    acc.add_(g)
        inv = 1.0 / accum_steps
        return loss_acc * inv, tree_unflatten(params, [g * inv for g in grads_acc])

    return fn


def _mean_over(loss, grads, axis):
    """The loss and the gradients averaged over ``axis``, each gradient in
    its own dtype as JAX's per-leaf ``pmean`` (bf16 for bf16 params, fp32
    after ``_accumulate``): one sum all-reduce of a flat buffer a dtype,
    divided by the axis size."""
    leaves = tree_leaves(grads)
    out = [None] * len(leaves)
    for dtype in dict.fromkeys(g.dtype for g in leaves):
        idx = [i for i, g in enumerate(leaves) if g.dtype == dtype]
        flat = comm.all_reduce(torch.cat([leaves[i].reshape(-1) for i in idx]), axis) / axis.size
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view(leaves[i].shape)
    loss = comm.all_reduce(loss.float().reshape(1), axis)[0] / axis.size
    return loss, tree_unflatten(grads, out)


def _local_rows(batch, axis, dim):
    """This rank's equal share of ``batch`` along ``dim`` over ``axis``."""
    if axis is None:
        return batch
    n = batch.shape[dim]
    if n % axis.size:
        raise ValueError(f"{axis.name} axis of {axis.size} ranks does not divide dimension {dim} of "
                         f"{tuple(batch.shape)}")
    return batch.narrow(dim, axis.index * (n // axis.size), n // axis.size)


def make_cp_train_step(
    mesh,
    cfg: ModelConfig,
    lr: float,
    *,
    seq_axis: str = SEQ,
    data_axis: str | None = None,
    remat: bool = True,
    grad_accum: int = 1,
):
    """Context-parallel (× optional data-parallel) training step:
    ``step(params, opt_state, batch, cos, sin) -> (params, opt_state,
    loss)``, one SGD-with-momentum step at learning rate ``lr`` (where JAX
    takes an optax optimizer).

    ``batch`` is the GLOBAL (B, S+1) int token batch, the same on every
    rank: the inputs and targets are cut from it BEFORE sharding (a chunk's
    last target is the next chunk's first input), then rank (d, i) takes
    rows ``[d B/n_data, (d+1) B/n_data)`` and positions ``[i C, (i+1) C)``
    with ``C = S / n_seq``. ``params`` and ``opt_state`` (from
    :func:`init_opt_state`) are replicated and updated IN PLACE, identically
    on every rank. ``grad_accum`` microbatches the rank's local rows (the
    sequence stays whole, so the ring sees full chunks). ``loss`` is the
    global batch mean, the same on every rank.
    """
    seq = mesh.axis(seq_axis)
    data = None if data_axis is None else mesh.axis(data_axis)
    axes = [a for a in (data, seq) if a is not None]

    def vg(params, inp, tgt, cos, sin):
        return value_and_grad(
            lambda p: loss_tokens(p, inp, tgt, cfg, cos, sin, use_flash=True, remat=remat,
                                  seq_axis_name=seq), params)

    def step(params, opt_state, batch, cos, sin):
        batch = torch.as_tensor(batch, device=mesh.device)
        inp, tgt = batch[:, :-1], batch[:, 1:]
        inp, tgt = (_local_rows(_local_rows(x, data, 0), seq, 1) for x in (inp, tgt))
        if grad_accum > 1:
            loss, grads = _accumulate(lambda p, i, t: vg(p, i, t, cos, sin), grad_accum)(params, inp, tgt)
        else:
            loss, grads = vg(params, inp, tgt, cos, sin)
        # equal chunks: the global mean is the mean of the chunk means;
        # replicated params need it over every activation-sharding axis
        for axis in axes:
            loss, grads = _mean_over(loss, grads, axis)
        sgd_update_(params, opt_state, grads, lr)
        return params, opt_state, loss

    return step
