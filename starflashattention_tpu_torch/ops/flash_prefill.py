"""Flash-attention prefill — twin of the JAX ``ops/flash_prefill.py``.

``flash_prefill(q, k, v, lengths, q_offsets=...)`` -> (B, Hq, Sq, D): query
row i of sequence b sits at absolute position ``q_offsets[b] + i`` and
attends KV positions ``j < lengths[b]``, and with ``causal`` (the default)
also ``j <= q_offsets[b] + i``. ``return_lse=True`` also returns the per-row
log-sum-exp (B, Hq, Sq) fp32 in base-2 units of the scaled scores,
``m2 + log2(l)`` with ``s2 = sm_scale * log2(e) * q.k``, and 3e38 for a row
that saw no valid position (the JAX contract, which the backward in
``ops/flash_bwd.py`` reads). On CUDA tensors it launches
``csrc/flash_prefill.cu`` (which replaces the TPU kernel
``_prefill_kernel``); on CPU tensors it runs :func:`flash_prefill_plain`.
Padded query rows (past a sequence's valid tokens) still produce values,
which the caller discards.

The causal prefill, with or without the LSE (the serving prefill and the
training forward), takes the attention variants: a sliding ``window`` (row
p attends ``j > p - window``), ``sinks`` (``j < sinks`` stays attendable,
with a window) and a ``softcap`` (``cap * tanh(s / cap)`` on the
natural-unit scaled score, before the base-2 conversion; the LSE is then
that of the capped scores). With ``causal=False`` they raise
``NotImplementedError``. ``kv_offset`` (ring context parallelism, JAX
``flash_prefill.py:118``) is the global position of ``k[:, :, 0]``: it moves
only the sinks' boundary, ``j < sinks - kv_offset`` with ``j`` local to the
chunk (the causal diagonal moves through ``q_offsets``), so the kernel is
passed ``max(sinks - kv_offset, 0)`` as its sink bound (:func:`prefill_options`)
and needs no form of its own. A chunk wholly in a query row's future (a
negative ``q_offsets``) or past its length gives that row 0 and the LSE
3e38.
head_dim is 64, 128 or 256 with at most 8 query heads a KV head, and on the
card also 640 (MLA's latent row: DeepSeek-V2's 16 query heads on one
latent KV head) in its one form, causal, without the LSE or the variants,
with an even number of query heads a KV head (:func:`check_card_inputs`).
The D 640 kernel's tiles, walk and block order have Python twins
(:func:`latent_geometry`, :func:`latent_rows`, :func:`latent_walk`,
:func:`latent_takes`, :func:`latent_tile_order`, :func:`latent_clusters`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from starflashattention_tpu_torch.core.reference import NEG_INF, mha_reference, repeat_kv
from starflashattention_tpu_torch.ops import _build
from starflashattention_tpu_torch.ops.flash_decode import (KERNEL_HEAD_DIMS, LATENT_HEAD_DIM,
                                                           kernel_options, variant_options)

LOG2E = math.log2(math.e)
LSE_EMPTY = 3e38  # the LSE of a row with no valid KV position

_SIGNATURES = {
    "flash_prefill": [_build.P] * 7 + [_build.I] * 7 + [_build.F, _build.F, _build.I, _build.I,
                                                      _build.F, _build.P],
    "flash_prefill_latent_geometry": [_build.I, _build.P],
}

# K5 at D 640 (``flash_prefill_latent_kernel``): a cluster of LATENT_CTAS
# blocks owns a tile of LATENT_ROWS (position, head) rows of one KV head,
# each block half of the 640 lanes; K/V tiles of LATENT_KEYS keys; the
# warpgroups of LATENT_GROUP_ROWS rows skip the tiles that lie wholly past
# their last position.
LATENT_ROWS, LATENT_KEYS, LATENT_CTAS, LATENT_GROUP_ROWS = 128, 32, 2, 64


def prefill_options(window, sinks, softcap, kv_offset, causal) -> dict:
    """The checked variants of a prefill call (see the module doc), with the
    sinks' bound moved into a chunk that starts at global position
    ``kv_offset``: ``max(sinks - kv_offset, 0)``."""
    kv_offset = int(kv_offset)
    if kv_offset < 0:
        raise ValueError(f"kv_offset must be >= 0, got {kv_offset}")
    if not causal and (window is not None or sinks or softcap is not None):
        raise NotImplementedError(
            "window / sinks / softcap with causal=False are not ported yet (ROADMAP Queue 2, K5 "
            "and K12 options)")
    opts = variant_options(window, sinks, softcap)
    opts["sinks"] = max(opts["sinks"] - kv_offset, 0)
    return opts


def scales(d: int, sm_scale: float | None) -> tuple[float, float]:
    """(sm_scale, sm_scale * log2 e) as the kernels take them."""
    scale = 1.0 / d**0.5 if sm_scale is None else float(sm_scale)
    return scale, scale * LOG2E


def _defaults(q, k, lengths, q_offsets):
    b, skv = q.shape[0], k.shape[2]
    if lengths is None:
        lengths = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    lengths = torch.clamp(lengths.to(device=q.device, dtype=torch.int32), max=skv)
    if q_offsets is None:
        q_offsets = torch.zeros((b,), dtype=torch.int32, device=q.device)
    return lengths, q_offsets.to(device=q.device, dtype=torch.int32)


def attention_mask(sq, skv, lengths, q_offsets, causal, device, window=None, sinks=0) -> torch.Tensor:
    """(B, 1, Sq, Skv) bool: KV position j is valid for query row i (below
    the length; with ``causal`` at most the row's position; with a
    ``window`` in its band or a sink)."""
    kv_pos = torch.arange(skv, device=device)[None, None, None, :]
    mask = kv_pos < lengths[:, None, None, None]
    if causal or window is not None:
        q_pos = torch.arange(sq, device=device)[None, None, :, None] + q_offsets[:, None, None, None]
        if causal:
            mask = mask & (kv_pos <= q_pos)
        if window is not None:
            mask = mask & ((kv_pos > q_pos - window) | (kv_pos < sinks))
    return mask


def scores_log2(q, k, sm_scale, softcap=None):
    """fp32 base-2 scores (B, Hq, Sq, Skv) as K5 computes them from the raw
    fp32 ``q.k``: ``sm_scale * log2(e) * q.k``, or with a ``softcap``
    ``cap * t * log2(e)`` with ``t = tanh(sm_scale * q.k / cap)``. Returns
    (scores, t), t None without a cap."""
    kf = repeat_kv(k, q.shape[1] // k.shape[1]).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf)
    scale, scale_log2 = scales(q.shape[-1], sm_scale)
    if softcap is None:
        return s * scale_log2, None
    t = torch.tanh(s * scale / softcap)
    return softcap * t * LOG2E, t


def prefill_lse_plain(q, k, lengths, q_offsets, *, causal, sm_scale, window=None, sinks=0,
                      softcap=None) -> torch.Tensor:
    """The base-2 LSE (B, Hq, Sq) fp32 of :func:`flash_prefill_plain`'s
    scores; 3e38 for a row with no valid position."""
    mask = attention_mask(q.shape[2], k.shape[2], lengths, q_offsets, causal, q.device, window, sinks)
    s2 = torch.where(mask, scores_log2(q, k, sm_scale, softcap)[0], NEG_INF)
    m = s2.amax(dim=-1)
    l = (torch.exp2(s2 - m[..., None]) * mask).sum(dim=-1)
    return torch.where(l > 0, m + torch.log2(l.clamp(min=1e-37)), LSE_EMPTY)


def flash_prefill_plain(q, k, v, lengths=None, *, causal=True, q_offsets=None, sm_scale=None,
                        return_lse=False, window=None, sinks=0, softcap=None, kv_offset=0):
    """Plain PyTorch version: full-softmax attention at fp32 (and its LSE),
    with the variants and ``kv_offset``."""
    opts = prefill_options(window, sinks, softcap, kv_offset, causal)
    lengths, q_offsets = _defaults(q, k, lengths, q_offsets)
    out = mha_reference(q, k, v, lengths=lengths, causal=causal, q_offset=q_offsets,
                        sm_scale=sm_scale, sliding_window=opts["window"],
                        attention_sinks=opts["sinks"], softcap=opts["softcap"])
    if not return_lse:
        return out
    return out, prefill_lse_plain(q, k, lengths, q_offsets, causal=causal, sm_scale=sm_scale, **opts)


# ----------------------------------------------------------------- K5 at D 640: its tiles and walk


def latent_geometry(g: int) -> tuple[int, int, int, int]:
    """(heads a tile ``hb``, positions a tile ``bq``, head groups a position
    tile ``nhg``, dynamic shared memory bytes a block) of the D 640 kernel at
    ``g`` query heads a KV head: ``hb = min(g, 128)`` heads by ``128 // hb``
    positions (rows past ``hb * bq`` idle; a group past 128 heads takes
    ``nhg`` tiles a position tile). A block holds Q's 320 lanes of the 128
    rows, K tiles of 32 keys in a ring of 3 slots and V tiles in one of 2
    (all in wgmma's 128-byte swizzle, 1024-aligned) and two buffers of
    every warp's partial scores. Twin of ``csrc/flash_prefill.cu``'s
    ``latent::Rows`` and ``latent::SMEM`` (``flash_prefill_latent_geometry``
    reports the same)."""
    if g < 1:
        raise ValueError(f"the D 640 kernel takes at least one query head a KV head, got {g}")
    hb = min(g, LATENT_ROWS)
    half, warps, k_slots, v_slots = LATENT_HEAD_DIM // LATENT_CTAS, 8, 3, 2
    smem = (1024 + LATENT_ROWS * half * 2 + (k_slots + v_slots) * LATENT_KEYS * half * 2
            + 2 * warps * 16 * LATENT_KEYS * 4 + (k_slots + v_slots + 2 * warps) * 8)
    return hb, LATENT_ROWS // hb, -(-g // hb), smem


def latent_rows(g: int, sq: int, qt: int, hg: int) -> list:
    """The rows of tile (position tile ``qt``, head group ``hg``), position
    major: row r is ``(head within the KV head, q row)`` = ``(hg * hb + r %
    hb, qt * bq + r // hb)``, or None for an idle row (past ``hb * bq``,
    past the group or past ``sq``)."""
    hb, bq, _, _ = latent_geometry(g)
    rows = []
    for r in range(LATENT_ROWS):
        p, h = r // hb, hg * hb + r % hb
        rows.append((h, qt * bq + p) if p < bq and h < g and qt * bq + p < sq else None)
    return rows


def latent_walk(qt: int, *, bq: int, sq: int, length: int, q_offset: int) -> int:
    """The number of K/V tiles (of LATENT_KEYS keys, from key 0) position
    tile ``qt`` walks: below ``length`` and, causal, through its last
    position (its last row clipped to ``sq``). Twin of
    ``csrc/flash_prefill.cu``'s ``latent::walk_tiles``."""
    end = min(length, q_offset + min(qt * bq + bq, sq))
    return -(-end // LATENT_KEYS) if end > 0 else 0


def latent_tile_order(n_tiles: int, walk_len) -> list[int]:
    """The tiles of a launch in cluster order (each over every (KV head,
    sequence) before the next): from the end whose tile has the longer walk
    in sequence 0 (``walk_len(tile)``), so that the longest walks start
    first. Twin of ``csrc/flash_prefill.cu``'s ``latent_tile``."""
    return list(range(n_tiles - 1, -1, -1)) if walk_len(n_tiles - 1) >= walk_len(0) else list(range(n_tiles))


def latent_clusters(b: int, hkv: int, sq: int, skv: int, g: int, lengths, q_offsets) -> list:
    """The clusters of a D 640 launch in order (``blockIdx.x // 2``): each
    ``(sequence, KV head, position tile, head group)``. Tile ``T`` is
    position tile ``T // nhg``, head group ``T % nhg``."""
    _, bq, nhg, _ = latent_geometry(g)
    n_tiles = -(-sq // bq) * nhg

    def walk_len(tile):
        return latent_walk(tile // nhg, bq=bq, sq=sq, length=min(int(lengths[0]), skv), q_offset=int(q_offsets[0]))

    order = latent_tile_order(n_tiles, walk_len)
    return [(xb // hkv, xb % hkv, order[y] // nhg, order[y] % nhg)
            for y in range(n_tiles) for xb in range(hkv * b)]


def latent_takes(rows: list, q_offset: int, n_tiles: int) -> list[int]:
    """The walk tiles each warpgroup of a tile computes: the prefix of the
    ``n_tiles`` tiles that start at or below its last live position (its
    rows ``rows[64 w: 64 w + 64]``, as :func:`latent_rows` gives them; none
    for a warpgroup with no live row). Twin of the kernel's ``n_take``."""
    takes = []
    for w0 in range(0, LATENT_ROWS, LATENT_GROUP_ROWS):
        hi = max((q_offset + r[1] for r in rows[w0:w0 + LATENT_GROUP_ROWS] if r is not None), default=-1)
        takes.append(min(n_tiles, hi // LATENT_KEYS + 1) if hi >= 0 else 0)
    return takes


def latent_built_geometry(g: int) -> tuple[int, ...]:
    """The built library's D 640 tiles at ``g``: (rows, keys, hb, bq, nhg,
    blocks a cluster, shared memory bytes) (loads it)."""
    lib = _build.load("flash_prefill", _SIGNATURES)
    out = (ctypes.c_int * 7)()
    _build.check(lib, lib.flash_prefill_latent_geometry(g, out), "flash_prefill_latent_geometry")
    return tuple(out)


def check_card_inputs(what, q, k, v, head_dims=KERNEL_HEAD_DIMS, latent=None) -> None:
    """The shapes and types the CUDA kernels of K5 and K12 take: head_dim in
    ``head_dims``, at most 8 query heads a KV head, bf16. ``latent`` (K5
    only): the call's ``(causal, return_lse, options)``, with which head_dim
    640 passes in its one form (causal, no LSE, no options, an even group)."""
    b, hq, _, d = q.shape
    _, hkv, _, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape or hq % hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if latent is not None and d == LATENT_HEAD_DIM:
        causal, return_lse, opts = latent
        if not causal or return_lse or any(opts.values()):
            raise ValueError(f"{what}: head_dim {d} (MLA's latent row) takes the causal prefill without "
                             "the LSE, window, sinks or softcap (ROADMAP Queue 2: K5 / K12 at D 640)")
        if (hq // hkv) % 2:
            raise ValueError(f"{what}: head_dim {d} takes an even number of query heads a KV head, "
                             f"got {hq // hkv}")
        head_dims = (d,)
    elif hq // hkv > 8:
        raise ValueError(f"{what}: the CUDA kernel takes at most 8 query heads per KV head, "
                         f"got {hq // hkv}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"{what}: the CUDA kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in head_dims:
        raise ValueError(f"{what}: the CUDA kernel takes head_dim {' or '.join(map(str, head_dims))}, "
                         f"got {d}")


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
):
    """Blockwise prefill attention -> (B, Hq, Sq, D) in q's dtype, and with
    ``return_lse`` also the base-2 LSE (B, Hq, Sq) fp32; ``window``,
    ``sinks``, ``softcap`` and ``kv_offset`` as in the module doc."""
    opts = prefill_options(window, sinks, softcap, kv_offset, causal)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, lengths, causal=causal, q_offsets=q_offsets,
                                   sm_scale=sm_scale, return_lse=return_lse, **opts)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    check_card_inputs("flash_prefill", q, k, v, latent=(causal, return_lse, opts))
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    lengths, q_offsets = _defaults(q, k, lengths, q_offsets)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lengths, q_offsets = lengths.contiguous(), q_offsets.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    lib = _build.load("flash_prefill", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_prefill(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(lengths),
            _build.ptr(q_offsets), _build.ptr(out), None if lse is None else _build.ptr(lse),
            b, hq, hkv, sq, skv, d, int(causal), *scales(d, sm_scale),
            *kernel_options(**opts), _build.stream_ptr(q.device),
        )
    _build.check(lib, err, "flash_prefill")
    flash_prefill.launches += 1
    flash_prefill.launches_kv_offset += int(kv_offset) > 0
    if not return_lse:
        return out
    flash_prefill.launches_lse += 1
    flash_prefill.launches_lse_banded += opts["window"] is not None
    return out, lse


flash_prefill.launches = 0
flash_prefill.launches_lse = 0  # the launches with return_lse (the training forward)
flash_prefill.launches_lse_banded = 0  # those of them with a window
flash_prefill.launches_kv_offset = 0  # the launches on a chunk past position 0 (ring context parallelism)
