"""Causal flash-attention prefill — twin of the JAX ``ops/flash_prefill.py``.

``flash_prefill(q, k, v, lengths, q_offsets=...)`` -> (B, Hq, Sq, D): query
row i of sequence b sits at absolute position ``q_offsets[b] + i`` and
attends KV positions ``j <= q_offsets[b] + i`` with ``j < lengths[b]``. On
CUDA tensors it launches ``csrc/flash_prefill.cu`` (which replaces the TPU
kernel ``_prefill_kernel``); on CPU tensors it runs
:func:`flash_prefill_plain`. Padded query rows (past a sequence's valid
tokens) still produce values, which the caller discards.

Options this slice does not port (sliding window, sinks, softcap,
``kv_offset``, ``return_lse``, non-causal) raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.core.reference import mha_reference
from starflashattention_tpu_torch.ops import _build

_SIGNATURES = {
    "flash_prefill": [_build.P] * 6 + [_build.I] * 6 + [_build.F, _build.P],
}


def _defaults(q, k, lengths, q_offsets):
    b, skv = q.shape[0], k.shape[2]
    if lengths is None:
        lengths = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    lengths = torch.clamp(lengths.to(device=q.device, dtype=torch.int32), max=skv)
    if q_offsets is None:
        q_offsets = torch.zeros((b,), dtype=torch.int32, device=q.device)
    return lengths, q_offsets.to(device=q.device, dtype=torch.int32)


def flash_prefill_plain(q, k, v, lengths=None, *, causal=True, q_offsets=None, sm_scale=None):
    """Plain PyTorch version: full-softmax attention at fp32."""
    lengths, q_offsets = _defaults(q, k, lengths, q_offsets)
    return mha_reference(q, k, v, lengths=lengths, causal=causal,
                         q_offset=q_offsets, sm_scale=sm_scale)


def flash_prefill(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    lengths: torch.Tensor | None = None,  # (B,) valid KV length
    *,
    causal: bool = True,
    q_offsets: torch.Tensor | None = None,  # (B,) absolute position of q[:, :, 0]
    sm_scale: float | None = None,
    window=None,
    sinks: int = 0,
    kv_offset: int = 0,
    return_lse: bool = False,
    softcap: float | None = None,
) -> torch.Tensor:
    """Blockwise causal prefill attention -> (B, Hq, Sq, D) in q's dtype."""
    if not causal:
        raise NotImplementedError("non-causal prefill is not ported yet (ROADMAP Queue 2, K5 options)")
    if window is not None or sinks or softcap is not None or return_lse or kv_offset:
        raise NotImplementedError(
            "prefill window / sinks / softcap / return_lse / kv_offset are not ported yet "
            "(ROADMAP Queue 2, K5 options)")
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, lengths, causal=True, q_offsets=q_offsets,
                                   sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if hq // hkv > 8:
        raise ValueError(f"the CUDA kernel takes at most 8 query heads per KV head, got {hq // hkv}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"the CUDA kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in (64, 128):
        raise ValueError(f"the CUDA kernel takes head_dim 64 or 128, got {d}")
    lengths, q_offsets = _defaults(q, k, lengths, q_offsets)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lengths, q_offsets = lengths.contiguous(), q_offsets.contiguous()
    out = torch.empty_like(q)
    scale = 1.0 / d**0.5 if sm_scale is None else float(sm_scale)
    lib = _build.load("flash_prefill", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_prefill(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(lengths),
            _build.ptr(q_offsets), _build.ptr(out), b, hq, hkv, sq, skv, d, scale,
            _build.stream_ptr(q.device),
        )
    _build.check(lib, err, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
