"""Context-parallel ring attention — twin of the JAX ``parallel/ring.py``.

Q, K and V are sharded along the sequence over one mesh axis of n ranks.
Each rank keeps its Q chunk and the KV chunks rotate around the ring
(:func:`parallel.comm.start_ring_shift`, JAX's ``ppermute``): at step t a
rank holds the chunk of rank ``(i - t) mod n`` and attends it with K5
(``ops.flash_prefill`` with the LSE), called with the chunk-relative causal
diagonal (``q_offsets = my_start - chunk_start``), the global lengths
clipped into the chunk and ``kv_offset = chunk_start``, which moves the
sinks' boundary into the chunk. The step's output and base-2 LSE fold into
a running (acc, m, l) in fp32 (:func:`_merge_chunk`, the associative flash
merge). The rotation for step t + 1 is issued before step t's kernel, as
JAX issues it (``ring.py:113-118``).

The backward (:class:`_RingCore`, JAX's ``custom_vjp``) runs the same ring
with (k, v, dk, dv) travelling together: at each hop the resident rank adds
its (local q x travelling kv chunk) gradient, from K12 (``flash_bwd_dq``,
``flash_bwd_dkdv``) against the GLOBAL o and LSE, into fp32 accumulators
that travel with the chunk; after n hops every chunk is home with its whole
dk and dv. dq stays local. The next hop's k and v are issued before the
hop's kernels (they do not change); dk and dv go after them; the last hop
moves only dk and dv (JAX moves k and v home too, unused).

Layout contract. Every rank of the axis passes arrays of equal shape:
``ring_attention`` and ``make_ring_prefill`` (``balanced=False``) take rank
i's contiguous chunk, rows ``[i * C, (i + 1) * C)`` of the (B, H, S, D)
sequence, and return the output rows of the same positions; with
``balanced=True`` rank i passes and gets back the rows
``zigzag_permutation(S, n)[i * C:(i + 1) * C]``, global blocks i and
2n - 1 - i of 2n (see :func:`_zigzag_ring`). ``lengths`` (B,) is the
GLOBAL valid length, the same on every rank. Q and KV chunks must be equal:
a KV chunk is then either wholly at or below the Q chunk's positions or
wholly in its future, where the kernels walk no tile (0, and the LSE 3e38);
unequal chunks are rejected.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from starflashattention_tpu_torch.ops.flash_bwd import bwd_delta, flash_bwd_dkdv, flash_bwd_dq
from starflashattention_tpu_torch.ops.flash_prefill import LSE_EMPTY, flash_prefill
from starflashattention_tpu_torch.parallel import comm

_BIG = 1e37  # flash_prefill marks empty rows' LSE with +3e38; treat >= _BIG as "no data"
_NEG = -0.7 * float(np.finfo(np.float32).max)


@dataclasses.dataclass(frozen=True)
class _RingConfig:
    axis: object  # parallel.mesh.Axis
    causal: bool
    sm_scale: float | None
    window: int | None
    sinks: int
    softcap: float | None = None

    def kernel_kw(self, kv_offset: int) -> dict:
        return dict(causal=self.causal, sm_scale=self.sm_scale, window=self.window, sinks=self.sinks,
                    softcap=self.softcap, kv_offset=kv_offset)


def _merge_chunk(acc, m, l, o_t, lse_t):
    """Fold one chunk's normalized output + base-2 LSE into the running
    (acc, m, l) triple — the associative flash merge, keyed on log2 units."""
    lse_t = torch.where(lse_t >= _BIG, _NEG, lse_t)  # empty rows contribute 0
    m_new = torch.maximum(m, lse_t)
    # guard the all-empty case: m_new == _NEG would make both weights 2^0
    m_safe = torch.where(m_new <= _NEG, 0.0, m_new)
    r = torch.exp2(m - m_safe)[..., None]  # exp2(_NEG - m_safe) underflows to 0
    w = torch.exp2(lse_t - m_safe)[..., None]
    acc = acc * r + o_t.float() * w
    l = l * r[..., 0] + w[..., 0]
    return acc, m_new, l


def _chunk_rows(lengths, q_start, kv_start, c_kv, b, device):
    """The K5 / K12 ``lengths`` and ``q_offsets`` of a q chunk at global
    ``q_start`` against a KV chunk at ``kv_start``."""
    lens = (lengths - kv_start).clamp(0, c_kv).to(torch.int32)
    q_off = torch.full((b,), q_start - kv_start, dtype=torch.int32, device=device)
    return lens, q_off


def _ring_forward(cfg: _RingConfig, q, k, v, lengths):
    """n-step KV rotation; returns (o normalized in q's dtype, global base-2
    LSE), both for this rank's rows."""
    axis = cfg.axis
    n, idx = axis.size, axis.index
    b, hq, c_q, d = q.shape
    c_kv = k.shape[2]
    my_start = idx * c_q
    acc = torch.zeros((b, hq, c_q, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, c_q), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, c_q), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for t in range(n):
        # the NEXT step's rotation goes out before the chunk in hand is attended
        pending = comm.start_ring_shift([k_cur, v_cur], axis) if t + 1 < n else None
        chunk_start = ((idx - t) % n) * c_kv
        lens, q_off = _chunk_rows(lengths, my_start, chunk_start, c_kv, b, q.device)
        o_t, lse_t = flash_prefill(q, k_cur, v_cur, lens, q_offsets=q_off, return_lse=True,
                                   **cfg.kernel_kw(chunk_start))
        acc, m, l = _merge_chunk(acc, m, l, o_t, lse_t)
        if pending is not None:
            k_cur, v_cur = pending.wait()
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (acc / l_safe[..., None]).to(q.dtype)
    # rows that never saw valid KV keep the 3e38 the backward kernels expect
    lse = torch.where(l > 0.0, m + torch.log2(l.clamp(min=1e-37)), LSE_EMPTY)
    return o, lse


class _RingCore(torch.autograd.Function):
    """Ring attention with the ring backward (see the module doc)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, cfg):
        o, lse = _ring_forward(cfg, q, k, v, lengths)
        ctx.save_for_backward(q, k, v, lengths, o, lse)
        ctx.cfg = cfg
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths, o, lse = ctx.saved_tensors
        cfg = ctx.cfg
        axis = cfg.axis
        n, idx = axis.size, axis.index
        b, c_q, c_kv = q.shape[0], q.shape[2], k.shape[2]
        my_start = idx * c_q
        do = do.contiguous()
        delta = bwd_delta(o, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for t in range(n):
            pending = comm.start_ring_shift([k_cur, v_cur], axis) if t + 1 < n else None
            chunk_start = ((idx - t) % n) * c_kv
            lens, q_off = _chunk_rows(lengths, my_start, chunk_start, c_kv, b, q.device)
            kw = cfg.kernel_kw(chunk_start)
            dq += flash_bwd_dq(q, k_cur, v_cur, lse, do, delta, lens, q_off, **kw).float()
            dk_t, dv_t = flash_bwd_dkdv(q, k_cur, v_cur, lse, do, delta, lens, q_off, **kw)
            dk += dk_t.float()
            dv += dv_t.float()
            # the contribution rides with its chunk; the last hop brings every chunk home
            dk, dv = comm.ring_shift([dk, dv], axis)
            if pending is not None:
                k_cur, v_cur = pending.wait()
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def _check_chunks(q, k):
    if q.shape[2] != k.shape[2]:
        raise ValueError(
            "ring_attention requires equally-chunked Q and KV (got "
            f"q chunk {q.shape[2]}, kv chunk {k.shape[2]}): the future-chunk "
            "skip relies on aligned chunks"
        )


def _full_lengths(q, k, lengths, n):
    if lengths is None:
        # full sequences: S_global = n * C
        return torch.full((q.shape[0],), n * k.shape[2], dtype=torch.int32, device=q.device)
    return torch.as_tensor(lengths, device=q.device).to(torch.int32)


def ring_attention(
    q: torch.Tensor,  # (B, Hq, S/n, D) — this rank's query chunk
    k: torch.Tensor,  # (B, Hkv, S/n, D) — this rank's resident KV chunk
    v: torch.Tensor,
    lengths: torch.Tensor | None = None,  # (B,) GLOBAL valid lengths (the same on every rank)
    *,
    axis_name,  # parallel.mesh.Axis: the sequence axis
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
    sinks: int = 0,
    softcap: float | None = None,
) -> torch.Tensor:
    """Differentiable ring attention over ``axis_name`` (a
    :class:`parallel.mesh.Axis`): rank i passes rows ``[i * C, (i + 1) *
    C)`` of the sequence and gets back its output rows (contiguous layout;
    see :func:`make_ring_prefill` for the zigzag one). The same function as
    ``ops.flash_bwd.flash_attention`` on the gathered arrays, both ways:
    GQA, ragged ``lengths``, causal and the sliding ``window``, ``sinks``
    (the sinks' boundary moved into each chunk by ``kv_offset``) and the
    ``softcap`` behave as on one device. Every rank of the axis must call it
    (and run its backward) together."""
    _check_chunks(q, k)
    cfg = _RingConfig(axis=axis_name, causal=causal, sm_scale=None if sm_scale is None else float(sm_scale),
                      window=window, sinks=int(sinks), softcap=None if softcap is None else float(softcap))
    return _RingCore.apply(q, k, v, _full_lengths(q, k, lengths, axis_name.size), cfg)


def zigzag_permutation(seq_len: int, n: int, chunk: int | None = None) -> np.ndarray:
    """Position permutation for balanced causal ring attention.

    Splits the sequence into 2n blocks and assigns blocks (i, 2n-1-i) to
    rank i, so each rank's causal workload is the same (n+1)/2n share.
    Returns ``perm`` with ``x_balanced = x[..., perm, :]``; invert with
    ``np.argsort(perm)``.
    """
    if seq_len % (2 * n):
        raise ValueError(f"seq_len {seq_len} not divisible by 2n={2*n}")
    blk = seq_len // (2 * n)
    order = []
    for i in range(n):
        order.append(np.arange(i * blk, (i + 1) * blk))
        j = 2 * n - 1 - i
        order.append(np.arange(j * blk, (j + 1) * blk))
    return np.concatenate(order)


def _zigzag_ring(q, k, v, lengths, *, axis_name, causal=True, sm_scale=None, window=None, sinks=0,
                 softcap=None):
    """Rank body for balanced ring attention (forward only): the rank's
    chunk is the CONCATENATION of global blocks i and 2n-1-i. The ring runs
    at half-chunk granularity, the two blocks as separate q streams against
    the same rotating KV, so every (q half-block, kv half-block) pair is
    wholly causal or wholly skipped, as in the contiguous layout: 4 K5
    calls a step."""
    axis = axis_name
    n, idx = axis.size, axis.index
    b, hq, c2, d = q.shape
    c = c2 // 2  # half-chunk = one global block
    cfg = _RingConfig(axis=axis, causal=causal, sm_scale=sm_scale, window=window, sinks=int(sinks),
                      softcap=softcap)
    q_blocks = ((q[:, :, :c], idx * c), (q[:, :, c:], (2 * n - 1 - idx) * c))
    state = [(torch.zeros((b, hq, c, d), dtype=torch.float32, device=q.device),
              torch.full((b, hq, c), _NEG, dtype=torch.float32, device=q.device),
              torch.zeros((b, hq, c), dtype=torch.float32, device=q.device)) for _ in range(2)]
    k_cur, v_cur = k, v
    for t in range(n):
        pending = comm.start_ring_shift([k_cur, v_cur], axis) if t + 1 < n else None
        owner = (idx - t) % n
        kv_blocks = ((k_cur[:, :, :c], v_cur[:, :, :c], owner * c),
                     (k_cur[:, :, c:], v_cur[:, :, c:], (2 * n - 1 - owner) * c))
        for qi, (q_blk, q_start) in enumerate(q_blocks):
            for kb, vb, kv_start in kv_blocks:
                lens, q_off = _chunk_rows(lengths, q_start, kv_start, c, b, q.device)
                o_t, lse_t = flash_prefill(q_blk, kb, vb, lens, q_offsets=q_off, return_lse=True,
                                           **cfg.kernel_kw(kv_start))
                state[qi] = _merge_chunk(*state[qi], o_t, lse_t)
        if pending is not None:
            k_cur, v_cur = pending.wait()
    outs = [(acc / torch.where(l == 0.0, 1.0, l)[..., None]).to(q.dtype) for acc, _, l in state]
    return torch.cat(outs, dim=2)


def make_ring_prefill(
    mesh,
    *,
    seq_axis: str = "model",
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
    sinks: int = 0,
    balanced: bool = False,
    differentiable: bool = False,
):
    """``fn(q, k, v, lengths) -> o`` on this rank's shard of the sequence
    over ``mesh.axis(seq_axis)`` (the layout contract of the module doc):
    the cross-rank prefill counterpart of
    :func:`parallel.distributed_decode.make_seq_sharded_decode`.

    ``balanced=True`` takes the zigzag layout (rank i holds global blocks i
    and 2n-1-i), which evens the causal work across the ring (contiguous
    chunking leaves rank 0 about 2x idle); it is forward-only.
    ``differentiable=True`` returns the ring with its backward
    (:func:`ring_attention`, contiguous layout), the training entry point.
    """
    if balanced and differentiable:
        raise NotImplementedError(
            "balanced zigzag layout is forward-only; use balanced=False for "
            "training (the bwd ring uses the contiguous layout)"
        )
    axis = mesh.axis(seq_axis)
    kw = dict(causal=causal, sm_scale=sm_scale, window=window, sinks=sinks)
    if not balanced:
        def fn(q, k, v, lengths):
            if differentiable:
                return ring_attention(q, k, v, lengths, axis_name=axis, **kw)
            with torch.no_grad():
                return ring_attention(q, k, v, lengths, axis_name=axis, **kw)
        return fn

    @torch.no_grad()
    def fn(q, k, v, lengths):
        _check_chunks(q, k)
        if q.shape[2] % 2:
            raise ValueError(f"the zigzag layout holds two equal blocks a rank, got a chunk of {q.shape[2]}")
        return _zigzag_ring(q, k, v, _full_lengths(q, k, lengths, axis.size), axis_name=axis, **kw)

    return fn
