"""Differentiable flash attention — twin of the JAX ``ops/flash_bwd.py``.

``flash_prefill_bwd(q, k, v, o, lse, do, lengths, q_offsets)`` -> (dq, dk,
dv), the FlashAttention-2 backward of :func:`ops.flash_prefill.flash_prefill`
from its output ``o`` and its base-2 LSE. It recomputes, in fp32,

    s2 = sm_scale * log2(e) * q.k,   p = 2^(s2 - lse)   (0 off the mask)
    delta = rowsum(do * o),   dp = do.v,   ds = p * (dp - delta)
    dq = sm_scale * ds @ k,   dk = sm_scale * ds^T @ q,   dv = p^T @ do

with dk and dv summed over the GQA group. The JAX package folds
``sm_scale * log2(e)`` into q and rounds it to q's dtype before both passes,
so its dk carries ``ln 2`` where this one carries ``sm_scale``; the port
scales the fp32 scores in both kernels by the same fp32 ``sm_scale *
log2(e)``. The causal form takes the forward's variants: the mask gains
the band and the sinks (``window``, ``sinks``), and with a ``softcap`` the
scores are K5's capped ones, ``s2 = cap * t * log2(e)`` with ``t =
tanh(sm_scale * q.k / cap)``, and ``ds`` carries the tanh chain rule ``1 -
t^2``. ``delta`` is a torch reduction (:func:`bwd_delta`), as XLA computes
it outside Pallas; then :func:`flash_bwd_dq` and :func:`flash_bwd_dkdv`
launch the two kernels of ``csrc/flash_bwd.cu`` (which replace the TPU
kernels ``_dq_kernel`` and ``_dkdv_kernel``) on CUDA tensors, each counting
its launches, and run their plain versions on CPU tensors. The dq kernel
keeps a block's Q and dO rows (the q tile of every head of a KV head) in
shared memory and streams K and V past them; its tiles are
:func:`dq_geometry`, its walk of KV tiles :func:`dq_walk` and its block
order :func:`dq_tile_order` (the longest walks first). The dk/dv kernel
cuts each KV tile's walk of (head, q tile) steps into pieces across blocks
when the static shapes call for it (:func:`dkdv_split_plan`, on the built
kernel's tiles, :func:`dkdv_geometry`; the walk's twins :func:`dkdv_walk`
and :func:`dkdv_split_steps`), and a second pass adds the pieces' fp32 sums
in a fixed order.

:func:`flash_attention` is the training entry: a ``torch.autograd.Function``
whose forward is ``flash_prefill(return_lse=True)`` and whose backward is
``flash_prefill_bwd``, both with the same options. ``kv_offset`` (ring
context parallelism) moves the sinks' boundary as in the forward (JAX
``flash_bwd.py:93``, ``:168``): the kernels get ``max(sinks - kv_offset,
0)``. A chunk wholly in a row's future, or a row whose LSE is 3e38, gives
exact zeros. The variants with ``causal=False`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from starflashattention_tpu_torch.core.reference import repeat_kv
from starflashattention_tpu_torch.ops import _build
from starflashattention_tpu_torch.ops.flash_decode import kernel_options
from starflashattention_tpu_torch.ops.flash_prefill import (_defaults, attention_mask, check_card_inputs,
                                                            flash_prefill, prefill_options, scales,
                                                            scores_log2)
from starflashattention_tpu_torch.utils.device import sm_count

_ARGS = [_build.P] * 8
_OPTIONS = [_build.F, _build.F, _build.I, _build.I, _build.F, _build.P]  # scales, window, sinks, cap, stream
_SIGNATURES = {
    "flash_bwd_dq": _ARGS + [_build.P] + [_build.I] * 7 + _OPTIONS,
    "flash_bwd_dkdv": _ARGS + [_build.P] * 3 + [_build.I] * 9 + _OPTIONS,
    "flash_bwd_dkdv_geometry": [_build.I, _build.P],
    "flash_bwd_dq_geometry": [_build.I, _build.I, _build.P],
}

DKDV_MIN_CHUNK = 8  # the fewest (head, q tile) steps a split piece takes
DQ_KEYS = 64  # keys a K/V tile of the dq kernel's ring


def dq_geometry(d: int, g: int) -> tuple[int, int, int]:
    """(q rows of each head a block, keys a ring stage, dynamic shared
    memory bytes) of the dq kernel at head_dim ``d`` with ``g`` query heads
    a KV head. A block holds 128 rows (64 at D 256) of Q and dO, the q
    tile's ``128 // g`` rows of each head (rows past ``g`` times that idle),
    a ring of 3 stages (2 at D 256) of K and V tiles, dS and an mbarrier a
    stage; rows padded to D + 8 and 64 + 8 elements. Twin of
    ``csrc/flash_bwd.cu``'s ``DqGeom`` (its ``flash_bwd_dq_geometry``
    reports the same)."""
    if d not in (64, 128, 256) or not 1 <= g <= 8:
        raise ValueError(f"the dq kernel takes head_dim 64, 128 or 256 and 1-8 query heads a KV head, "
                         f"got {d} and {g}")
    rows, stages = (64, 2) if d > 128 else (128, 3)
    st = d + 8
    smem = 2 * rows * st * 2 + stages * 2 * DQ_KEYS * st * 2 + rows * (DQ_KEYS + 8) * 2 + stages * 8
    return rows // g, DQ_KEYS, smem


def dq_walk(qt, *, bq, bk, length, q_offset, causal, window=None, sinks=0) -> list[int]:
    """The KV tiles (of ``bk`` keys) that q tile ``qt`` (rows ``qt * bq`` ..
    of each head) of one sequence walks in the dq kernel, in walk order: the
    tiles in band (JAX ``flash_bwd._in_band``) below ``length``, causal up
    to the tile holding the q tile's last position (its last row, not
    clipped to Sq); with a ``window``, first the sink tiles below the tile
    that holds the q tile's first band start, then the tiles from that one
    (``sinks`` is the kernel's bound, ``max(sinks - kv_offset, 0)``). Twin
    of ``csrc/flash_bwd.cu``'s ``dq_walk``."""
    end = min(length, q_offset + (qt + 1) * bq) if causal else length
    nk = -(-end // bk) if end > 0 else 0
    if window is None:
        return list(range(nk))
    bt = max(q_offset + qt * bq - window + 1, 0) // bk
    ns = min(-(-min(sinks, bt * bk) // bk), nk)
    return list(range(ns)) + list(range(bt, nk))


def dq_tile_order(nqt: int, walk_len) -> list[int]:
    """The q tiles of a dq launch in block order (``blockIdx.y``; each
    takes every (KV head, sequence) before the next): from the end whose
    tile has the longer walk in sequence 0 (``walk_len(qt)``: its number of
    KV tiles), so that the longest walks start first. Twin of
    ``csrc/flash_bwd.cu``'s ``dq_tile``."""
    return list(range(nqt - 1, -1, -1)) if walk_len(nqt - 1) >= walk_len(0) else list(range(nqt))


@functools.cache
def dq_built_geometry(d: int, g: int) -> tuple[int, int, int]:
    """:func:`dq_geometry` as the built library reports it (loads it)."""
    lib = _build.load("flash_bwd", _SIGNATURES)
    out = (ctypes.c_int * 3)()
    _build.check(lib, lib.flash_bwd_dq_geometry(d, g, out), "flash_bwd_dq_geometry")
    return tuple(out)


def dkdv_walk(kt, *, bkv, bq, sq, length, q_offset, causal, window=None, sinks=0) -> tuple[int, int]:
    """The q walk of KV tile ``kt`` (rows ``kt * bkv`` on) of one sequence
    in the dk/dv kernel -> (first q tile, number of q tiles): the q tiles in
    band (JAX ``flash_bwd._in_band``): none when the tile starts at or past
    ``length``; causal, from the first q tile whose last row reaches the
    tile; with a ``window``, up to the last q tile whose first row's band
    reaches the tile's last row, unless the tile holds sinks (``sinks`` is
    the kernel's bound, ``max(sinks - kv_offset, 0)``). Twin of
    ``csrc/flash_bwd.cu``'s ``kv_walk``."""
    j0 = kt * bkv
    i_begin = max(0, j0 - q_offset) // bq * bq if causal else 0
    i_end = sq if j0 < length else 0
    if window is not None and j0 >= sinks:
        i_end = min(i_end, max(0, j0 + bkv - 1 + window - 1 - q_offset + 1))
    return i_begin // bq, -(-(i_end - i_begin) // bq) if i_end > i_begin else 0


def dkdv_walk_splits(steps: int, chunk: int) -> int:
    """Pieces of a walk of ``steps`` (head, q tile) steps, ``chunk`` a
    piece; 1 for an empty walk (its block writes the zeros)."""
    return -(-steps // chunk) if steps else 1


def dkdv_split_steps(nq: int, g: int, chunk: int, split: int) -> list[tuple[int, int]]:
    """The steps that piece ``split`` of a KV tile's walk of ``nq`` q tiles
    takes: (head in the group, q tile offset from the walk's first), in the
    kernel's order (head-major); [] past the tile's pieces."""
    steps = g * nq
    if split >= dkdv_walk_splits(steps, chunk):
        return []
    return [(t // nq, t % nq) for t in range(split * chunk, min(steps, (split + 1) * chunk))]


@functools.lru_cache(maxsize=256)
def dkdv_split_plan(b, hkv, g, sq, skv, causal, window, sinks, sms, bkv, bq) -> tuple[int, int]:
    """(chunk, splits) of a dk/dv launch on tiles of ``bkv`` KV rows and
    ``bq`` q rows (:func:`dkdv_geometry`), from the static shapes alone: the
    KV tiles' walks estimated with full lengths and the queries at the
    keys' last ``sq`` positions (a training step's, where ``sq == skv``).
    When the longest walk is no longer than the steps a block slot takes on
    average (``sms`` slots, one block an SM), the blocks balance unsplit:
    one piece of every walk (chunk = the longest possible walk). Else each
    piece takes at most half a slot's average, and ``splits`` is the most
    pieces any walk of these shapes can need."""
    full = g * -(-sq // bq)
    walks = [g * dkdv_walk(kt, bkv=bkv, bq=bq, sq=sq, length=skv, q_offset=max(skv - sq, 0),
                           causal=causal, window=window, sinks=sinks)[1] for kt in range(-(-skv // bkv))]
    per_slot = b * hkv * sum(walks) / sms
    if max(walks, default=0) <= per_slot:
        return max(full, 1), 1
    chunk = max(math.ceil(per_slot / 2), DKDV_MIN_CHUNK)
    return chunk, dkdv_walk_splits(full, chunk)


@functools.cache
def dkdv_geometry(d: int) -> tuple[int, int, int]:
    """(KV rows a block, q rows a step, dynamic shared memory bytes) of the
    built dk/dv kernel at head_dim ``d`` (loads the library)."""
    lib = _build.load("flash_bwd", _SIGNATURES)
    out = (ctypes.c_int * 3)()
    _build.check(lib, lib.flash_bwd_dkdv_geometry(d, out), "flash_bwd_dkdv_geometry")
    return tuple(out)


def dkdv_longest_walk(q: torch.Tensor, k: torch.Tensor) -> int:
    """The (head, q tile) steps of the longest walk a dk/dv launch can have
    on the built kernel's tiles: every q tile of the group's heads."""
    return q.shape[1] // k.shape[1] * -(-q.shape[2] // dkdv_geometry(q.shape[3])[1])


def _group_sum(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Hq, S, D) -> (B, Hkv, S, D): the sum over each KV head's group."""
    b, hq, s, d = x.shape
    return x.reshape(b, hkv, hq // hkv, s, d).sum(dim=2)


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(do * o)`` (B, Hq, Sq) in fp32."""
    return (do.float() * o.float()).sum(dim=-1)


def _p_ds_plain(q, k, v, lse, do, delta, lengths, q_offsets, causal, sm_scale, window, sinks, softcap):
    """fp32 P and dS (B, Hq, Sq, Skv) recomputed from the LSE, on K5's
    scores and mask."""
    lengths, q_offsets = _defaults(q, k, lengths, q_offsets)
    mask = attention_mask(q.shape[2], k.shape[2], lengths, q_offsets, causal, q.device, window, sinks)
    s2, t = scores_log2(q, k, sm_scale, softcap)
    p = torch.where(mask, torch.exp2(s2 - lse.float()[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), repeat_kv(v, q.shape[1] // v.shape[1]).float())
    ds = p * (dp - delta[..., None])
    return p, ds if t is None else ds * (1.0 - t * t)


def flash_bwd_dq_plain(q, k, v, lse, do, delta, lengths=None, q_offsets=None, *, causal=True,
                       sm_scale=None, window=None, sinks=0, softcap=None, kv_offset=0):
    """Plain version of the dq kernel: ``sm_scale * ds @ k`` in fp32."""
    opts = prefill_options(window, sinks, softcap, kv_offset, causal)
    _, ds = _p_ds_plain(q, k, v, lse, do, delta, lengths, q_offsets, causal, sm_scale, **opts)
    kf = repeat_kv(k, q.shape[1] // k.shape[1]).float()
    return (scales(q.shape[-1], sm_scale)[0] * torch.einsum("bhqk,bhkd->bhqd", ds, kf)).to(q.dtype)


def flash_bwd_dkdv_plain(q, k, v, lse, do, delta, lengths=None, q_offsets=None, *, causal=True,
                         sm_scale=None, window=None, sinks=0, softcap=None, kv_offset=0):
    """Plain version of the dk/dv kernel: ``sm_scale * ds^T @ q`` and
    ``p^T @ do`` in fp32, summed over each KV head's group."""
    opts = prefill_options(window, sinks, softcap, kv_offset, causal)
    p, ds = _p_ds_plain(q, k, v, lse, do, delta, lengths, q_offsets, causal, sm_scale, **opts)
    hkv = k.shape[1]
    dk = scales(q.shape[-1], sm_scale)[0] * _group_sum(torch.einsum("bhqk,bhqd->bhkd", ds, q.float()), hkv)
    dv = _group_sum(torch.einsum("bhqk,bhqd->bhkd", p, do.float()), hkv)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_prefill_bwd_plain(q, k, v, o, lse, do, lengths=None, q_offsets=None, *, causal=True,
                            sm_scale=None, window=None, sinks=0, softcap=None, kv_offset=0):
    """Plain PyTorch version of :func:`flash_prefill_bwd`: the same formulas
    in fp32 on explicit (B, Hq, Sq, Skv) tensors, each gradient in its
    input's dtype."""
    delta = bwd_delta(o, do)
    kw = dict(causal=causal, sm_scale=sm_scale, **prefill_options(window, sinks, softcap, kv_offset, causal))
    dq = flash_bwd_dq_plain(q, k, v, lse, do, delta, lengths, q_offsets, **kw)
    return (dq, *flash_bwd_dkdv_plain(q, k, v, lse, do, delta, lengths, q_offsets, **kw))


def _card_args(what, q, k, v, lse, do, delta, lengths, q_offsets):
    """Checks for the kernels, and their contiguous inputs."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    check_card_inputs(what, q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{what}: do {tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != q.shape[:3] or x.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be fp32 {tuple(q.shape[:3])}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    lengths, q_offsets = _defaults(q, k, lengths, q_offsets)
    return [x.contiguous() for x in (q, k, v, do, lse, delta, lengths, q_offsets)]


def _launch(entry, ins, outs, causal, sm_scale, opts, split=()):
    q, k = ins[0], ins[1]
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    lib = _build.load("flash_bwd", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(*[None if x is None else _build.ptr(x) for x in ins + outs],
                                  b, hq, hkv, sq, skv, d, int(causal), *split, *scales(d, sm_scale),
                                  *kernel_options(**opts), _build.stream_ptr(q.device))
    _build.check(lib, err, entry)


def flash_bwd_dq(q, k, v, lse, do, delta, lengths=None, q_offsets=None, *, causal=True,
                 sm_scale=None, window=None, sinks=0, softcap=None, kv_offset=0) -> torch.Tensor:
    """dq (B, Hq, Sq, D) in q's dtype: the dq kernel of ``csrc/flash_bwd.cu``
    on CUDA tensors (replaces ``_dq_kernel``), :func:`flash_bwd_dq_plain`
    on CPU tensors. ``delta`` is :func:`bwd_delta` of the forward's output;
    the options are the forward's."""
    opts = prefill_options(window, sinks, softcap, kv_offset, causal)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, lse, do, delta, lengths, q_offsets, causal=causal,
                                  sm_scale=sm_scale, **opts)
    ins = _card_args("flash_bwd_dq", q, k, v, lse, do, delta, lengths, q_offsets)
    dq = torch.empty_like(ins[0])
    if not (dq.numel() and k.numel()):
        return dq.zero_()
    _launch("flash_bwd_dq", ins, [dq], causal, sm_scale, opts)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.launches_kv_offset += int(kv_offset) > 0
    flash_bwd_dq.launches_banded += opts["window"] is not None
    return dq


def flash_bwd_dkdv(q, k, v, lse, do, delta, lengths=None, q_offsets=None, *, causal=True,
                   sm_scale=None, window=None, sinks=0, softcap=None,
                   kv_offset=0) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) (B, Hkv, Skv, D) in k's / v's dtype: the dk/dv kernel of
    ``csrc/flash_bwd.cu`` on CUDA tensors (replaces ``_dkdv_kernel``), its
    walks split as :func:`dkdv_split_plan` says; :func:`flash_bwd_dkdv_plain`
    on CPU tensors."""
    opts = prefill_options(window, sinks, softcap, kv_offset, causal)
    if q.device.type == "cpu":
        return flash_bwd_dkdv_plain(q, k, v, lse, do, delta, lengths, q_offsets, causal=causal,
                                    sm_scale=sm_scale, **opts)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    check_card_inputs("flash_bwd_dkdv", q, k, v)  # a head_dim the kernel takes, before its geometry
    bkv, bq, _ = dkdv_geometry(d)
    plan = dkdv_split_plan(b, hkv, hq // hkv, sq, skv, bool(causal), opts["window"], opts["sinks"],
                           sm_count(q.device), bkv, bq)
    return flash_bwd_dkdv_split(q, k, v, lse, do, delta, lengths, q_offsets, plan=plan, causal=causal,
                                sm_scale=sm_scale, window=window, sinks=sinks, softcap=softcap,
                                kv_offset=kv_offset)


def flash_bwd_dkdv_split(q, k, v, lse, do, delta, lengths=None, q_offsets=None, *, plan, causal=True,
                         sm_scale=None, window=None, sinks=0, softcap=None,
                         kv_offset=0) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_bwd_dkdv` on CUDA tensors with its walks cut as ``plan``
    = (chunk, splits) says: pieces of ``chunk`` (head, q tile) steps, at
    most ``splits`` a walk (``splits`` 1: every walk in one block, bf16
    written directly; else an fp32 workspace of ``splits`` pieces and the
    second pass). Counts its launches on :func:`flash_bwd_dkdv`."""
    opts = prefill_options(window, sinks, softcap, kv_offset, causal)
    ins = _card_args("flash_bwd_dkdv", q, k, v, lse, do, delta, lengths, q_offsets)
    dk, dv = torch.empty_like(ins[1]), torch.empty_like(ins[2])
    if not (dk.numel() and q.numel()):
        return dk.zero_(), dv.zero_()
    chunk, splits = plan
    if chunk < 1 or chunk * splits < dkdv_longest_walk(q, k):
        raise ValueError(f"flash_bwd_dkdv: a plan of {splits} pieces of {chunk} steps does not cover the "
                         f"longest walk, {dkdv_longest_walk(q, k)} (head, q tile) steps")
    ws = None if splits == 1 else torch.empty((splits, 2, *k.shape), dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dkdv", ins, [dk, dv, ws], causal, sm_scale, opts, split=(chunk, splits))
    flash_bwd_dkdv.launches += 1
    flash_bwd_dkdv.launches_split += splits > 1
    flash_bwd_dkdv.launches_kv_offset += int(kv_offset) > 0
    flash_bwd_dkdv.launches_banded += opts["window"] is not None
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkdv.launches = 0
flash_bwd_dq.launches_banded = 0  # the launches with a window (a sliding layer's)
flash_bwd_dkdv.launches_banded = 0
flash_bwd_dq.launches_kv_offset = 0  # the launches on a chunk past position 0 (ring context parallelism)
flash_bwd_dkdv.launches_kv_offset = 0
flash_bwd_dkdv.launches_split = 0  # the launches whose walks were cut into pieces (a second pass sums them)


def flash_prefill_bwd(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, Hq, Sq, D) the forward's output
    lse: torch.Tensor,  # (B, Hq, Sq) fp32, base-2 (flash_prefill(return_lse=True))
    do: torch.Tensor,  # (B, Hq, Sq, D) cotangent of o
    lengths: torch.Tensor | None = None,  # (B,)
    q_offsets: torch.Tensor | None = None,  # (B,)
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    window=None,
    sinks: int = 0,
    kv_offset: int = 0,
    softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the flash prefill attention, in q's / k's / v's
    dtype: ``delta`` as a torch reduction, then the dq and the dk/dv kernels
    (their plain versions on CPU tensors), with the forward's ``window``,
    ``sinks``, ``softcap`` and ``kv_offset``."""
    delta = bwd_delta(o, do)
    kw = dict(causal=causal, sm_scale=sm_scale, window=window, sinks=sinks, softcap=softcap,
              kv_offset=kv_offset)
    dq = flash_bwd_dq(q, k, v, lse, do, delta, lengths, q_offsets, **kw)
    return (dq, *flash_bwd_dkdv(q, k, v, lse, do, delta, lengths, q_offsets, **kw))


class _FlashAttention(torch.autograd.Function):
    """Forward: K5 with the LSE; backward: K12, both with the options in
    ``ctx.opts``. On CPU tensors both run their plain versions (the
    wrappers choose by device)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, q_offsets, causal, sm_scale, opts):
        o, lse = flash_prefill(q, k, v, lengths, causal=causal, q_offsets=q_offsets,
                               sm_scale=sm_scale, return_lse=True, **opts)
        ctx.save_for_backward(q, k, v, o, lse, lengths, q_offsets)
        ctx.causal, ctx.sm_scale, ctx.opts = causal, sm_scale, opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, lengths, q_offsets = ctx.saved_tensors
        dq, dk, dv = flash_prefill_bwd(q, k, v, o, lse, do, lengths, q_offsets, causal=ctx.causal,
                                       sm_scale=ctx.sm_scale, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    causal: bool = True,
    q_offsets: torch.Tensor | None = None,
    sm_scale: float | None = None,
    window=None,
    sinks: int = 0,
    softcap: float | None = None,
) -> torch.Tensor:
    """Differentiable flash attention (the training entry point): the
    forward of :func:`flash_prefill` with gradients for q, k and v through
    :func:`flash_prefill_bwd`, with the sliding ``window``, ``sinks`` and
    ``softcap`` of both (causal only); O(S) memory both ways (one fp32 LSE a
    row is kept, the score tiles are recomputed)."""
    opts = prefill_options(window, sinks, softcap, 0, causal)
    lengths, q_offsets = _defaults(q, k, lengths, q_offsets)
    return _FlashAttention.apply(q, k, v, lengths, q_offsets, causal, sm_scale, opts)
