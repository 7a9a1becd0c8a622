"""Paged flash decode — twin of the JAX ``ops/paged_decode.py``.

``paged_flash_decode`` attends one query token per sequence against the
first ``lengths[b]`` positions of its sequence, read from the
(L, Hkv, P, page_size, D) page pools through the (B, pages_per_seq) page
table. On CUDA tensors it launches the paged form of
``csrc/flash_decode_split.cu`` (it replaces the TPU kernel
``_paged_decode_kernel``): the contiguous decode's (K1's) split KV walk on
its chunk grid, with each KV row's address resolved through the table,
merged by the last block in the same launch. On CPU tensors it runs
:func:`paged_flash_decode_plain`. ``paged_flash_decode_append`` folds the
decode step's paged row append (``append_rows_paged_kv``, kernel K8) into
that launch, bit for bit K8 followed by K7 (see
``ops/flash_decode.flash_decode_append``).

As the JAX wrapper does, ``sm_scale`` is folded into q and the scaled q is
rounded to q's dtype before the dot products. Int8 / fp8 pools fold
``sm_scale * k_scale[h]`` into q the same way, and the fp32 output is
multiplied by ``v_scale[h]`` and cast to q's dtype once (JAX
paged_decode.py:341-346, :404-406): the kernel does both itself; the plain
route does them around its attention with torch ops. A row of length 0
gives exactly 0 (the JAX kernel also gives 0 there). ``window``, ``sinks``
and ``softcap`` act as in ``ops/flash_decode.py`` (the softcap on the
scaled, rounded q's scores); the kernel never reads a page table entry below
a row's band that is not a sink, so pages the engine has reclaimed (entries
set to the null page 0) are never read. ``pages_per_compute_block`` and
``max_len_hint`` size the TPU grid and are accepted and unused. head_dim as
in ``ops/flash_decode.py``: 640 (MLA's latent row) in bf16 without the
variants, at most 16 query heads a KV head.
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.core.reference import NEG_INF, repeat_kv
from starflashattention_tpu_torch.ops import _build
from starflashattention_tpu_torch.ops.cache_append import append_rows_paged_kv_plain
from starflashattention_tpu_torch.ops.flash_decode import (_quantized, cap_scores, check_append,
                                                           check_head_dim, fold_k_scale, has_variants,
                                                           in_band, kv_dtype_code, launch_split,
                                                           scale_heads, variant_options)

_CUDA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _as_stack(k_pages, v_pages, layer):
    """(Hkv, P, ps, D) pools become a one-layer stack at layer 0."""
    if k_pages.dim() == 4:
        return k_pages[None], v_pages[None], 0
    if layer is None:
        raise ValueError("layer index required for a stacked (L, ...) page pool")
    return k_pages, v_pages, int(layer)


def _scaled_q(q, sm_scale):
    d = q.shape[-1]
    scale = 1.0 / d**0.5 if sm_scale is None else float(sm_scale)
    return (q.float() * scale).to(q.dtype)


def _core_plain(q, k_pages, v_pages, page_table, lengths, layer, sm_scale, window=None, sinks=0,
                softcap=None):
    """Gather each sequence's pages into a dense (B, Hkv, S, D) copy and run
    a masked fp32 softmax over q * sm_scale rounded to q's dtype -> fp32
    (B, Hq, D)."""
    b, hq, d = q.shape
    _, hkv, _, ps, _ = k_pages.shape
    table = page_table.to(q.device).long()
    s = table.shape[1] * ps

    def dense(pool):  # (Hkv, B, pages_per_seq, ps, D) -> (B, Hkv, S, D)
        return pool[layer][:, table].permute(1, 0, 2, 3, 4).reshape(b, hkv, s, d)

    k = repeat_kv(dense(k_pages), hq // hkv).float()
    v = repeat_kv(dense(v_pages), hq // hkv).float()
    scores = cap_scores(torch.einsum("bhd,bhkd->bhk", _scaled_q(q, sm_scale).float(), k), softcap)
    mask = in_band(torch.arange(s, device=q.device)[None, None, :],
                   lengths.to(q.device)[:, None, None], window, sinks)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhk,bhkd->bhd", p, v) / torch.where(l == 0, torch.ones_like(l), l)


def _paged_plain(q, k_pages, v_pages, page_table, lengths, layer, sm_scale, k_scales, v_scales,
                 opts):
    """The plain route: quantized pools fold their scales around
    :func:`_core_plain` as the JAX wrapper does (q * sm_scale * k_scale
    rounded to q's dtype, the fp32 output times v_scale, one cast)."""
    k_pages, v_pages, layer = _as_stack(k_pages, v_pages, layer)
    if not _quantized(k_pages, k_scales, v_scales):
        return _core_plain(q, k_pages, v_pages, page_table, lengths, layer, sm_scale,
                           **opts).to(q.dtype)
    o = _core_plain(fold_k_scale(q, sm_scale, k_scales), k_pages, v_pages, page_table, lengths,
                    layer, 1.0, **opts)
    return scale_heads(o, v_scales).to(q.dtype)  # one cast


def paged_flash_decode_plain(q, k_pages, v_pages, page_table, lengths, *, layer=None,
                             sm_scale=None, k_scales=None, v_scales=None, window=None, sinks=0,
                             softcap=None):
    """Plain PyTorch version -> (B, Hq, D) in q's dtype (quantized pools and
    the variants included)."""
    return _paged_plain(q, k_pages, v_pages, page_table, lengths, layer, sm_scale, k_scales,
                        v_scales, variant_options(window, sinks, softcap))


def _paged_kernel(q, k_pages, v_pages, page_table, lengths, layer, sm_scale, k_scales, v_scales,
                  window=None, sinks=0, softcap=None, append=None):
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    k_pages, v_pages, layer = _as_stack(k_pages, v_pages, layer)
    scales = (k_scales, v_scales) if _quantized(k_pages, k_scales, v_scales) else None
    l_, hkv, num_pages, ps, d = k_pages.shape
    b, hq, _ = q.shape
    if q.shape != (b, hq, d) or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pools {tuple(k_pages.shape)}")
    if q.dtype not in _CUDA_DTYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"the CUDA kernel takes fp32 or bf16 q and one pool dtype, got "
                         f"{q.dtype} / {k_pages.dtype} / {v_pages.dtype}")
    kv_code = kv_dtype_code(q.dtype, k_pages.dtype)
    check_head_dim("paged_flash_decode", d, q.dtype, k_pages.dtype,
                   not has_variants(window, sinks, softcap), group=hq // hkv)
    if v_pages.shape != k_pages.shape or not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("K and V pools must be contiguous and of one shape")
    if page_table.dim() != 2 or page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / lengths {tuple(lengths.shape)} "
                         f"do not match {b} rows")
    if not 0 <= layer < l_:
        raise ValueError(f"layer {layer} out of range for {l_} layers")
    q = q.contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    layer_bytes = hkv * num_pages * ps * d * k_pages.element_size()
    out = torch.empty_like(q)
    scale = 1.0 / d**0.5 if sm_scale is None else float(sm_scale)
    k_ptr = _build.P(k_pages.data_ptr() + layer * layer_bytes)
    v_ptr = _build.P(v_pages.data_ptr() + layer * layer_bytes)
    launch_split(q, k_ptr, v_ptr, lengths, hkv=hkv, s=table.shape[1] * ps, scale=scale,
                 kv_code=kv_code, scales=scales, out=out, pages=(table, num_pages, ps),
                 window=window, sinks=sinks, softcap=softcap, append=append)
    paged_flash_decode.launches += 1
    if append is not None:
        paged_flash_decode_append.launches += 1
    return out


def paged_flash_decode(
    q: torch.Tensor,  # (B, Hq, D)
    k_pages: torch.Tensor,  # (Hkv, P, ps, D) or (L, Hkv, P, ps, D) with `layer`
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, pages_per_seq) int32
    lengths: torch.Tensor,  # (B,) int32
    *,
    layer: int | None = None,
    sm_scale: float | None = None,
    pages_per_compute_block: int = 4,
    k_scales: torch.Tensor | None = None,  # (Hkv,) fp32 for int8 / fp8 pools
    v_scales: torch.Tensor | None = None,
    max_len_hint: int | None = None,
    window=None,
    sinks: int = 0,
    softcap: float | None = None,
) -> torch.Tensor:
    """Paged decode attention -> (B, Hq, D) in q's dtype (kernel K7), with
    the optional ``window`` / ``sinks`` / ``softcap``. Each launch counts
    once in ``paged_flash_decode.launches``."""
    del pages_per_compute_block, max_len_hint  # TPU grid sizing; see the module doc
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pages, v_pages, page_table, lengths, layer=layer,
                                        sm_scale=sm_scale, k_scales=k_scales, v_scales=v_scales,
                                        window=window, sinks=sinks, softcap=softcap)
    return _paged_kernel(q, k_pages, v_pages, page_table, lengths, layer, sm_scale, k_scales,
                         v_scales, **variant_options(window, sinks, softcap))


paged_flash_decode.launches = 0


def paged_flash_decode_append_plain(q, k_pages, v_pages, page_table, k_new, v_new, pos, lengths, *,
                                    layer=None, sm_scale=None, k_scales=None, v_scales=None,
                                    window=None, sinks=0, softcap=None):
    """Plain twin of :func:`paged_flash_decode_append`:
    :func:`append_rows_paged_kv_plain` at ``min(pos, pages_per_seq *
    page_size - 1)``, then :func:`paged_flash_decode_plain`."""
    k_stack, v_stack, lidx = _as_stack(k_pages, v_pages, layer)
    last = page_table.shape[1] * k_stack.shape[3] - 1
    append_rows_paged_kv_plain(k_stack, v_stack, k_new, v_new, lidx, page_table,
                               torch.clamp(pos, max=last))
    return paged_flash_decode_plain(q, k_pages, v_pages, page_table, lengths, layer=layer,
                                    sm_scale=sm_scale, k_scales=k_scales, v_scales=v_scales,
                                    window=window, sinks=sinks, softcap=softcap)


def paged_flash_decode_append(
    q: torch.Tensor,  # (B, Hq, D)
    k_pages: torch.Tensor,  # (Hkv, P, ps, D) or (L, Hkv, P, ps, D) with `layer`
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, pages_per_seq) int32
    k_new: torch.Tensor,  # (B, Hkv, D) in the pools' dtype, contiguous, 16-byte aligned
    v_new: torch.Tensor,
    pos: torch.Tensor,  # (B,) int32 logical write positions, clamped to pages_per_seq * ps - 1
    lengths: torch.Tensor,  # (B,) int32 attended rows, the new one included
    *,
    layer: int | None = None,
    sm_scale: float | None = None,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    window=None,
    sinks: int = 0,
    softcap: float | None = None,
) -> torch.Tensor:
    """The paged decode step's append (``append_rows_paged_kv``, K8) folded
    into K7's launch: writes ``pool[layer, :, page_table[b, p // ps], p %
    ps] = new[b]`` at ``p = min(pos[b], pages_per_seq * ps - 1)`` for K and
    V IN PLACE, then returns :func:`paged_flash_decode` over ``lengths``,
    bit for bit K8 followed by K7. A row whose table entry is the null page
    0 writes there, as K8 does. Each launch counts in
    ``paged_flash_decode.launches`` and ``paged_flash_decode_append.launches``;
    ``pos`` and ``lengths`` are never read back to the host. Raises
    ``ValueError`` on rows the kernel does not take
    (``ops.flash_decode.check_append``) on either route."""
    k_stack, _, _ = _as_stack(k_pages, v_pages, layer)
    check_append("paged_flash_decode_append", q, k_new, v_new, pos, k_stack.dtype, k_stack.shape[1],
                 k_stack.shape[4])
    opts = variant_options(window, sinks, softcap)
    if q.device.type == "cpu":
        return paged_flash_decode_append_plain(q, k_pages, v_pages, page_table, k_new, v_new, pos,
                                               lengths, layer=layer, sm_scale=sm_scale,
                                               k_scales=k_scales, v_scales=v_scales, **opts)
    return _paged_kernel(q, k_pages, v_pages, page_table, lengths, layer, sm_scale, k_scales,
                         v_scales, **opts, append=(k_new, v_new, pos, None))


paged_flash_decode_append.launches = 0  # the launches that folded an append (all also in paged_flash_decode's)
