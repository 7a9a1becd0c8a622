"""Cross-rank split-KV flash decode — twin of the JAX
``parallel/distributed_decode.py``.

Each rank of a sequence axis holds a contiguous shard of the KV cache, runs
K2 (``ops.flash_decode.flash_decode_with_stats``: split-KV partials, the
unnormalized (o, m, l) in natural-log units) on its shard, collapses its
splits (:func:`lse_reduce_local`), and the ranks merge with a max
all-reduce of m and one sum all-reduce of the packed (B, Hq, D + 1)
tensor (:func:`merge_partials_across_chips`, JAX ``:25-50``): a context
longer than one card's memory decodes with O(D) communication per (batch,
head).

Layout contract (:func:`make_seq_sharded_decode`): every rank passes the
same q (B, Hq, D) and ``lengths`` (B,) (global valid lengths) and its KV
shard (B, Hkv, S/n, D), rows ``[i * S/n, (i + 1) * S/n)`` of the cache;
every rank gets back the whole (B, Hq, D) output in q's dtype.
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.ops.flash_decode import flash_decode_with_stats
from starflashattention_tpu_torch.parallel import comm


def merge_partials_across_chips(
    o_local: torch.Tensor,  # (B, Hq, D) unnormalized local partial
    m_local: torch.Tensor,  # (B, Hq)
    l_local: torch.Tensor,  # (B, Hq)
    axis_name,  # parallel.mesh.Axis
    out_dtype=None,
) -> torch.Tensor:
    """LSE-merge partial attention results across the ranks of
    ``axis_name``: two collectives, the max of m, then one sum of the packed
    (B, Hq, D+1) tensor that carries l as its last lane."""
    m_global = comm.all_reduce(m_local, axis_name, "max")  # (B, Hq)
    alpha = torch.exp(m_local - m_global)
    packed = torch.cat([alpha[..., None] * o_local, (alpha * l_local)[..., None]], dim=-1)
    packed = comm.all_reduce(packed, axis_name, "sum")
    o_global, l_global = packed[..., :-1], packed[..., -1]
    l_safe = torch.where(l_global == 0.0, 1.0, l_global)
    o = o_global / l_safe[..., None]
    return o.to(out_dtype) if out_dtype is not None else o


def lse_reduce_local(o_parts, m_parts, l_parts):
    """Collapse the rank's split axis to one (o, m, l) triple per (batch,
    head) before the cross-rank merge."""
    m_local = m_parts.amax(dim=-1)  # (B, H)
    alpha = torch.exp(m_parts - m_local[..., None])
    l_local = (alpha * l_parts).sum(dim=-1)
    o_local = torch.einsum("bhn,bhnd->bhd", alpha, o_parts)
    return o_local, m_local, l_local


def _local_decode(q, k_shard, v_shard, lengths, shard_start, *, axis, num_splits, block_k,
                  k_scales=None, v_scales=None):
    """Attend the local KV shard with lengths clipped to it (a shard wholly
    past a sequence's length gives l = 0 and drops out of the merge), then
    merge over the axis."""
    local_len = (lengths - shard_start).clamp(0, k_shard.shape[2]).to(torch.int32)
    # K2 reads the shard as a dense (B, Hkv, S, D) block: a head slice is copied
    k_shard, v_shard = k_shard.contiguous(), v_shard.contiguous()
    o, m, l = flash_decode_with_stats(q, k_shard, v_shard, local_len, num_splits=num_splits,
                                      block_k=block_k, k_scales=k_scales, v_scales=v_scales)
    o, m, l = lse_reduce_local(o, m, l)
    return merge_partials_across_chips(o, m, l, axis, out_dtype=q.dtype)


def make_seq_sharded_decode(
    mesh,
    *,
    seq_axis: str = "model",
    num_splits: int = 4,
    block_k: int = 256,
    quantized: bool = False,
    head_chunks: int = 1,
):
    """``fn(q, k_shard, v_shard, lengths[, k_scales, v_scales]) -> o`` with
    the KV cache sequence-sharded over ``mesh.axis(seq_axis)`` (the layout
    contract of the module doc); ``quantized=True`` takes an int8 / fp8
    shard and its (Hkv,) scales.

    ``head_chunks > 1`` runs the KV heads in that many slices, each with its
    own K2 launch and merge, as JAX's option does (there, to let one
    slice's collectives overlap the next slice's kernel). The port gives no
    such overlap: each merge's all-reduces complete before the next slice's
    K2 is launched, on any backend. The option is kept for parity with the
    JAX API; the math is unchanged (heads are independent), and it costs a
    dense copy of each head slice of the shard and twice the collectives. A
    head count it does not divide runs as one chunk, as in JAX."""
    axis = mesh.axis(seq_axis)

    @torch.no_grad()
    def body(q, k_shard, v_shard, lengths, k_scales=None, v_scales=None):
        lengths = torch.as_tensor(lengths, device=q.device)
        shard_start = axis.index * k_shard.shape[2]
        hkv = k_shard.shape[1]
        g = q.shape[1] // hkv
        kw = dict(axis=axis, num_splits=num_splits, block_k=block_k)
        if head_chunks == 1 or hkv % head_chunks:
            return _local_decode(q, k_shard, v_shard, lengths, shard_start, k_scales=k_scales,
                                 v_scales=v_scales, **kw)
        per = hkv // head_chunks
        outs = []
        for c in range(head_chunks):
            kv_sl = slice(c * per, (c + 1) * per)
            q_sl = slice(c * per * g, (c + 1) * per * g)
            outs.append(_local_decode(
                q[:, q_sl], k_shard[:, kv_sl], v_shard[:, kv_sl], lengths, shard_start,
                k_scales=None if k_scales is None else k_scales[kv_sl],
                v_scales=None if v_scales is None else v_scales[kv_sl], **kw))
        return torch.cat(outs, dim=1)

    if quantized:
        return body
    return lambda q, k, v, lengths: body(q, k, v, lengths)
