"""Plain PyTorch reference attention — the port's numerics spec.

Twin of the JAX package's ``core/reference.py``: full-softmax attention at
fp32 with GQA, ragged lengths, causal prefill, the sliding window, sinks
and softcap, and the split-KV LSE merge.
The plain versions of the kernels in ``ops/`` are built on these.

One deliberate difference: a row with no valid KV position (length 0)
returns 0 here. The JAX reference masks with a large negative score and so
returns the mean of V for such a row; that is a quirk, not a contract, and
the tests never compare rows of length 0.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads for GQA: (B, Hkv, ...) -> (B, Hkv * n_rep, ...)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=1)


def _masked_softmax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with masked entries exactly 0; a row with
    no valid entry is all zeros."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    denom = p.sum(dim=-1, keepdim=True)
    return p / torch.where(denom == 0, torch.ones_like(denom), denom)


def mha_reference(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    lengths: torch.Tensor | None = None,  # (B,) valid KV length per sequence
    causal: bool = False,
    q_offset: torch.Tensor | None = None,  # (B,) absolute position of q[:, :, 0]
    sm_scale: float | None = None,
    sliding_window: int | None = None,  # row p attends [p - W + 1, p]
    attention_sinks: int = 0,  # first-k positions always attendable (with a window)
    softcap: float | None = None,  # cap * tanh(s / cap) on the scaled scores
) -> torch.Tensor:
    """Full-softmax multi-head attention at fp32 -> (B, Hq, Sq, D) in q's
    dtype. Query row i sits at ``q_offset + i``; with ``causal`` it attends
    KV positions ``j <= q_offset + i``, and always ``j < lengths``; with
    ``sliding_window`` also ``j > q_offset + i - W`` or ``j <
    attention_sinks``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    assert hq % hkv == 0, (hq, hkv)
    k = repeat_kv(k, hq // hkv).float()
    v = repeat_kv(v, hq // hkv).float()
    if sm_scale is None:
        sm_scale = 1.0 / (d**0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)

    kv_pos = torch.arange(skv, device=q.device)[None, None, None, :]
    mask = torch.ones((b, 1, sq, skv), dtype=torch.bool, device=q.device)
    if lengths is not None:
        mask = mask & (kv_pos < lengths.to(q.device)[:, None, None, None])
    q_pos = torch.arange(sq, device=q.device)[None, None, :, None]
    if q_offset is not None:
        q_pos = q_pos + q_offset.to(q.device)[:, None, None, None]
    if causal:
        mask = mask & (kv_pos <= q_pos)
    if sliding_window is not None:
        band = kv_pos > q_pos - sliding_window
        if attention_sinks:
            band = band | (kv_pos < attention_sinks)
        mask = mask & band
    p = _masked_softmax(s, mask)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def decode_reference(
    q: torch.Tensor,  # (B, Hq, D) — one new token per sequence
    k_cache: torch.Tensor,  # (B, Hkv, S, D) — already holds the new token
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) valid cache positions (incl. the new token)
    *,
    sm_scale: float | None = None,
    sliding_window: int | None = None,
    attention_sinks: int = 0,
    softcap: float | None = None,
) -> torch.Tensor:
    """Decode attention: one query per sequence against its cache prefix;
    the query sits at ``lengths - 1``, so a window keeps ``[lengths - W,
    lengths)`` (and the sinks)."""
    o = mha_reference(
        q[:, :, None, :], k_cache, v_cache, lengths=lengths, sm_scale=sm_scale,
        q_offset=lengths.to(q.device) - 1, sliding_window=sliding_window,
        attention_sinks=attention_sinks, softcap=softcap,
    )
    return o[:, :, 0, :]


def decode_reference_with_stats(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode attention as UNNORMALIZED (o_acc, m, l) partials in natural-log
    units: ``o = o_acc / l`` after a global merge."""
    b, hq, d = q.shape
    hkv = k_cache.shape[1]
    k = repeat_kv(k_cache, hq // hkv).float()
    v = repeat_kv(v_cache, hq // hkv).float()
    if sm_scale is None:
        sm_scale = 1.0 / (d**0.5)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k) * sm_scale
    mask = (torch.arange(k.shape[2], device=q.device)[None, None, :]
            < lengths.to(q.device)[:, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * mask
    l = p.sum(dim=-1)
    o_acc = torch.einsum("bhk,bhkd->bhd", p, v)
    return o_acc, m, l


def lse_combine(
    o_parts: torch.Tensor,  # (N, ..., D) unnormalized partial outputs
    m_parts: torch.Tensor,  # (N, ...) running maxes
    l_parts: torch.Tensor,  # (N, ...) running exp-sums
) -> torch.Tensor:
    """Merge N split-KV partials by log-sum-exp rescaling; splits that saw
    no valid KV (m = NEG_INF, l = 0, o = 0) drop out."""
    m_parts = m_parts.float()
    l_parts = l_parts.float()
    m_global = m_parts.amax(dim=0)
    alpha = torch.exp(m_parts - m_global[None])
    l_global = (alpha * l_parts).sum(dim=0)
    o_global = (alpha[..., None] * o_parts.float()).sum(dim=0)
    l_safe = torch.where(l_global == 0.0, torch.ones_like(l_global), l_global)
    return o_global / l_safe[..., None]


def prefill_reference(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    *,
    lengths: torch.Tensor | None = None,
    causal: bool = True,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Causal multi-token prefill attention."""
    return mha_reference(q, k, v, lengths=lengths, causal=causal, sm_scale=sm_scale)
