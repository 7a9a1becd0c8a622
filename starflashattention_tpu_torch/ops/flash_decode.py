"""Split-KV flash decode over a multi-layer contiguous cache — twin of the
JAX ``ops/flash_decode.py``.

``flash_decode`` attends one query token per sequence against its cache
prefix; ``flash_decode_with_stats`` returns the per-split unnormalized
partials ``(o, m, l)`` that :func:`lse_combine_splits` merges. On CUDA
tensors both launch ``csrc/flash_decode.cu``, one kernel with two output
modes (it replaces the TPU kernels ``_decode_kernel_fused`` and
``_decode_kernel``); on CPU tensors they run the plain versions below.
The split boundaries come from :func:`_split_geometry`, a copy of the JAX
one, so the partials compare one to one.

Options this slice does not port (sliding window, sinks, softcap, quantized
caches, verify with ``qspan > 1``) raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.core.reference import NEG_INF, repeat_kv
from starflashattention_tpu_torch.ops import _build

_SIGNATURES = {
    "flash_decode": [_build.P] * 8 + [_build.I] * 7 + [_build.F, _build.I, _build.P],
}
_CUDA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _split_geometry(s: int, num_splits: int, block_k: int) -> tuple[int, int, int]:
    """Pick (num_splits, block_k, blocks_per_split) tiling S exactly: the
    largest block_k first, then the most splits (same search as JAX)."""
    cap = min(block_k, s)
    best = (0, 0)  # (bk, ns)
    for ns in range(num_splits, 0, -1):
        if s % ns:
            continue
        per_split = s // ns
        bk = next(b for b in range(min(cap, per_split), 0, -1) if per_split % b == 0)
        if (bk, ns) > best:
            best = (bk, ns)
    block_k, num_splits = best
    if block_k < 32 and s > 256:
        raise ValueError(
            f"KV cache length {s} has no block tiling >= 32 "
            f"(requested num_splits={num_splits}, block_k={block_k}); "
            "allocate the cache with max_seq_len a multiple of 512"
        )
    return num_splits, block_k, s // (num_splits * block_k)


def _reject_unported(window, sinks, softcap, k_scales, v_scales, max_len_hint=None):
    if window is not None or sinks:
        raise NotImplementedError(
            "sliding-window / sink decode is not ported yet (ROADMAP Queue 2, K1 options)")
    if softcap is not None:
        raise NotImplementedError("attention softcap is not ported yet (ROADMAP Queue 2, K1 options)")
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError("quantized KV caches are not ported yet (ROADMAP Queue 2, K1 options)")
    del max_len_hint  # a grid-size hint for the TPU kernel; the CUDA kernel walks each row's own length


def _as_table(k_cache, v_cache, layer):
    """(B, Hkv, S, D) caches become a one-layer table at layer 0."""
    if k_cache.dim() == 4:
        return k_cache[None], v_cache[None], 0
    if layer is None:
        raise ValueError("layer index required for a (L, ...) cache table")
    return k_cache, v_cache, int(layer)


# ----------------------------------------------------------------- plain versions


def _scores(q, k_layer, lengths, sm_scale):
    """fp32 scores (B, Hq, S) and the validity mask of one layer."""
    b, hq, d = q.shape
    hkv, s = k_layer.shape[1], k_layer.shape[2]
    k = repeat_kv(k_layer, hq // hkv).float()
    scale = 1.0 / d**0.5 if sm_scale is None else sm_scale
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), k) * scale
    mask = torch.arange(s, device=q.device)[None, None, :] < lengths.to(q.device)[:, None, None]
    return scores, mask


def flash_decode_with_stats_plain(q, k_cache, v_cache, lengths, *, layer=None,
                                  sm_scale=None, num_splits=4, block_k=256):
    """Plain PyTorch partials: per split, the running max ``m``, exp-sum
    ``l`` and unnormalized ``o`` over that split's valid positions. A split
    with none gives (0, NEG_INF, 0)."""
    k_cache, v_cache, layer = _as_table(k_cache, v_cache, layer)
    b, hq, d = q.shape
    s = k_cache.shape[3]
    n, _, _ = _split_geometry(s, num_splits, block_k)
    scores, mask = _scores(q, k_cache[layer], lengths, sm_scale)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    scores = scores.reshape(b, hq, n, s // n)
    mask = mask.expand(b, hq, s).reshape(b, hq, n, s // n)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None]) * mask
    l = p.sum(dim=-1)
    v = repeat_kv(v_cache[layer], hq // v_cache.shape[2]).float().reshape(b, hq, n, s // n, d)
    o = torch.einsum("bhnk,bhnkd->bhnd", p, v)
    return o, m, l


def flash_decode_plain(q, k_cache, v_cache, lengths, *, layer=None, sm_scale=None,
                       num_splits=4, block_k=256):
    """Plain PyTorch decode attention -> (B, Hq, D) in q's dtype. A row of
    length 0 gives 0."""
    k_cache, v_cache, layer = _as_table(k_cache, v_cache, layer)
    if _split_geometry(k_cache.shape[3], num_splits, block_k)[0] != 1:
        o, m, l = flash_decode_with_stats_plain(
            q, k_cache, v_cache, lengths, layer=layer, sm_scale=sm_scale,
            num_splits=num_splits, block_k=block_k)
        return lse_combine_splits(o, m, l, dtype=q.dtype)
    scores, mask = _scores(q, k_cache[layer], lengths, sm_scale)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1, keepdim=True)
    v = repeat_kv(v_cache[layer], q.shape[1] // v_cache.shape[2]).float()
    o = torch.einsum("bhk,bhkd->bhd", p, v) / torch.where(l == 0, torch.ones_like(l), l)
    return o.to(q.dtype)


def lse_combine_splits(o_parts, m_parts, l_parts, dtype=None):
    """Merge (B, H, N, ·) split partials by log-sum-exp rescaling -> (B, H, D).
    Plain PyTorch, as the JAX package left it to XLA."""
    m_global = m_parts.amax(dim=-1, keepdim=True)
    alpha = torch.exp(m_parts - m_global)
    l_global = (alpha * l_parts).sum(dim=-1)
    o = torch.einsum("bhn,bhnd->bhd", alpha, o_parts)
    o = o / torch.where(l_global == 0.0, torch.ones_like(l_global), l_global)[..., None]
    return o.to(dtype) if dtype is not None else o


# ----------------------------------------------------------------- kernel


def _launch(q, k_cache, v_cache, lengths, layer, sm_scale, n, split_len, fused):
    """Run csrc/flash_decode.cu on one layer of the table; returns the
    normalized output (fused) or the (o, m, l) partials."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    l_, b, hkv, s, d = k_cache.shape
    hq = q.shape[1]
    if q.shape != (b, hq, d) or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}")
    if q.dtype not in _CUDA_DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"the CUDA kernel takes q and cache both fp32 or bf16, got "
                         f"{q.dtype} / {k_cache.dtype}")
    if d not in (64, 128):
        raise ValueError(f"the CUDA kernel takes head_dim 64 or 128, got {d}")
    if v_cache.shape != k_cache.shape or not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("K and V tables must be contiguous and of one shape")
    if not 0 <= layer < l_:
        raise ValueError(f"layer {layer} out of range for {l_} layers")
    q = q.contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    layer_bytes = b * hkv * s * d * k_cache.element_size()
    k_ptr = _build.P(k_cache.data_ptr() + layer * layer_bytes)
    v_ptr = _build.P(v_cache.data_ptr() + layer * layer_bytes)
    if fused:
        out = torch.empty_like(q)
        parts = (None, None, None)
    else:
        out = None
        o = torch.empty((b, hq, n, d), dtype=torch.float32, device=q.device)
        m = torch.empty((b, hq, n), dtype=torch.float32, device=q.device)
        l = torch.empty((b, hq, n), dtype=torch.float32, device=q.device)
        parts = (o, m, l)
    scale = 1.0 / d**0.5 if sm_scale is None else float(sm_scale)
    lib = _build.load("flash_decode", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_decode(
            _build.ptr(q), k_ptr, v_ptr, _build.ptr(lengths),
            _build.ptr(out) if fused else None,
            *(None if t is None else _build.ptr(t) for t in parts),
            b, hq, hkv, s, d, n, split_len, scale, _CUDA_DTYPES[q.dtype],
            _build.stream_ptr(q.device),
        )
    _build.check(lib, err, "flash_decode")
    return out if fused else parts


def flash_decode_with_stats(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, Hkv, S, D) or (L, B, Hkv, S, D) with `layer`
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32, valid positions incl. the current token
    *,
    layer: int | None = None,
    sm_scale: float | None = None,
    num_splits: int = 4,
    block_k: int = 256,
    k_scales=None,
    v_scales=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split-KV decode -> unnormalized ``o`` (B, Hq, N, D) and natural-log
    ``m``, ``l`` (B, Hq, N), all fp32."""
    _reject_unported(None, 0, None, k_scales, v_scales)
    if q.device.type == "cpu":
        return flash_decode_with_stats_plain(
            q, k_cache, v_cache, lengths, layer=layer, sm_scale=sm_scale,
            num_splits=num_splits, block_k=block_k)
    k_cache, v_cache, layer = _as_table(k_cache, v_cache, layer)
    s = k_cache.shape[3]
    n, _, _ = _split_geometry(s, num_splits, block_k)
    parts = _launch(q, k_cache, v_cache, lengths, layer, sm_scale, n, s // n, fused=False)
    flash_decode.launches += 1
    return parts


def flash_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    layer: int | None = None,
    sm_scale: float | None = None,
    num_splits: int = 4,
    block_k: int = 256,
    k_scales=None,
    v_scales=None,
    max_len_hint: int | None = None,
    window=None,
    sinks: int = 0,
    softcap: float | None = None,
) -> torch.Tensor:
    """Decode attention: (B, Hq, D) query vs a (B, Hkv, S, D) cache — or a
    whole (L, B, Hkv, S, D) table plus ``layer`` — -> (B, Hq, D) in q's
    dtype. When the split geometry gives one split, the kernel normalizes in
    place; otherwise it writes partials and :func:`lse_combine_splits`
    merges them. Each launch (either mode) counts once in
    ``flash_decode.launches``."""
    _reject_unported(window, sinks, softcap, k_scales, v_scales, max_len_hint)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths, layer=layer,
                                  sm_scale=sm_scale, num_splits=num_splits, block_k=block_k)
    k_cache, v_cache, layer = _as_table(k_cache, v_cache, layer)
    s = k_cache.shape[3]
    n, _, _ = _split_geometry(s, num_splits, block_k)
    if n == 1:
        out = _launch(q, k_cache, v_cache, lengths, layer, sm_scale, 1, s, fused=True)
        flash_decode.launches += 1
        return out
    o, m, l = _launch(q, k_cache, v_cache, lengths, layer, sm_scale, n, s // n, fused=False)
    flash_decode.launches += 1
    return lse_combine_splits(o, m, l, dtype=q.dtype)


flash_decode.launches = 0
