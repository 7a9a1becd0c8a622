"""Attention step functions on the contiguous cache — twin of the JAX
``runtime/steps.py``: RoPE + cache append + attention for one layer.

``mha_fwd`` is the reference's ``mha_fwd_cuda`` API (a fused QKV row per
sequence in, one layer's attention out) and rides the same kernels as the
model: ``flash_decode_append``, the decode attention with the append
folded into its launch. The cache is updated IN PLACE; call
:func:`cache.contiguous.advance` once after all layers ran.
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.cache import contiguous
from starflashattention_tpu_torch.core.rope import apply_rope, rope_table
from starflashattention_tpu_torch.runtime.params import AttentionConfig
from starflashattention_tpu_torch.utils.device import resolve_device


def split_fused_qkv(qkv: torch.Tensor, cfg: AttentionConfig):
    """Split a fused projection (..., (Hq + 2*Hkv) * D) or (..., Hq+2Hkv, D)
    into q (..., Hq, D) and k, v (..., Hkv, D)."""
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    if qkv.shape[-1] == (hq + 2 * hkv) * d:
        qkv = qkv.reshape(*qkv.shape[:-1], hq + 2 * hkv, d)
    if qkv.shape[-2] != hq + 2 * hkv:
        raise ValueError(f"fused qkv {tuple(qkv.shape)} does not hold {hq}+2x{hkv} heads")
    return qkv[..., :hq, :], qkv[..., hq:hq + hkv, :], qkv[..., hq + hkv:, :]


def rope_tables(cfg: AttentionConfig, max_seq_len: int,
                device: torch.device | str | None = None):
    """fp32 cos/sin tables for ``cfg``'s rotary dim on ``device`` (default cuda)."""
    return rope_table(max_seq_len, cfg.rot_dim, base=cfg.rope_base,
                      device=resolve_device(device))


def attention_decode_step(
    cfg: AttentionConfig,
    cache: contiguous.KVCache,
    layer: int,
    q: torch.Tensor,  # (B, Hq, D), pre-RoPE
    k_new: torch.Tensor,  # (B, Hkv, D)
    v_new: torch.Tensor,
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
):
    """One layer's decode attention: RoPE(q, k_new) at position
    ``lengths``, append into the layer's cache IN PLACE, attend over
    ``lengths + 1`` positions. Returns ``(o (B, Hq, D), cache)``. An int8 /
    fp8 cache quantizes the new rows against its scales and attends with
    them: the decode kernel folds them in itself."""
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "attention_decode_step with a sliding window: the JAX step attends the whole cache "
            "there (ROADMAP Queue 3), so it has no reference yet; models/llama decodes windows")
    pos = cache.lengths
    q = apply_rope(q, pos, cos_table, sin_table, style=cfg.rope_style)
    k_new = apply_rope(k_new, pos, cos_table, sin_table, style=cfg.rope_style)
    o = contiguous.append_decode_attend(cache, layer, q, k_new, v_new, cache.lengths + 1,
                                        sm_scale=cfg.sm_scale, num_splits=cfg.num_splits,
                                        block_k=cfg.block_k)
    return o, cache


def mha_fwd(
    cfg: AttentionConfig,
    cache: contiguous.KVCache,
    layer: int,
    qkv: torch.Tensor,  # (B, Hq + 2*Hkv, D) fused projection of ONE new token
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
    q_bias: torch.Tensor | None = None,
    k_bias: torch.Tensor | None = None,
    v_bias: torch.Tensor | None = None,
):
    """The reference API's ``mha_fwd_cuda(qkv, q_bias, k_bias, v_bias,
    k_cache_table, v_cache_table, seq_len, ...)`` for one layer, with the
    biases applied. Runs on the device of its tensors."""
    q, k_new, v_new = split_fused_qkv(qkv, cfg)
    if q_bias is not None:
        q = q + q_bias.reshape(cfg.num_q_heads, cfg.head_dim)
    if k_bias is not None:
        k_new = k_new + k_bias.reshape(cfg.num_kv_heads, cfg.head_dim)
    if v_bias is not None:
        v_new = v_new + v_bias.reshape(cfg.num_kv_heads, cfg.head_dim)
    return attention_decode_step(cfg, cache, layer, q, k_new, v_new, cos_table, sin_table)
