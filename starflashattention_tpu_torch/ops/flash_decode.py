"""Split-KV flash decode over a multi-layer contiguous cache — twin of the
JAX ``ops/flash_decode.py``.

``flash_decode`` attends one query token per sequence against its cache
prefix; ``flash_decode_with_stats`` returns the per-split unnormalized
partials ``(o, m, l)`` that :func:`lse_combine_splits` merges;
``flash_verify`` attends T consecutive query tokens per sequence under the
staircase mask of speculative decoding's verify step (token j sees
``lengths[b] + j`` rows). On CUDA tensors all three launch
``csrc/flash_decode_split.cu`` (it replaces the TPU kernels
``_decode_kernel_fused``, in both its modes, and ``_decode_kernel``):
:func:`launch_split` splits the KV walk into chunks across blocks
(:func:`split_chunking`) and the last block of each (sequence, KV head)
merges them, in one launch; the split partials run the same kernel at the
caller's split geometry. On CPU tensors they run the plain versions below. The split boundaries come from :func:`_split_geometry`, a
copy of the JAX one, so the partials compare one to one.

``flash_decode_append`` is the decode step's row append (``append_rows_kv``,
kernel K3) folded into that launch, as the reference's
``flash_decoder_kernel`` does: the block whose chunk holds the write
position writes the new K/V row and reads it from the new rows, so one
launch gives the tables and the output of K3 followed by ``flash_decode``,
bit for bit. Its plain twin is :func:`append_rows_kv_plain` then
:func:`flash_decode_plain`. ``flash_verify_append`` does the same for the
verify step's block append (``append_block_kv``, kernel K9): the T new
rows of each sequence at ``min(pos, S - T)``, the first ``n_valid`` of
them, written by the blocks whose chunks hold them (a span across a chunk
edge has two) and read from the new rows, bit for bit K9 then
:func:`flash_verify`; its twin is :func:`append_block_kv_plain` then
:func:`flash_verify_plain`.

Quantized caches (int8 / fp8 tables with (Hkv,) ``k_scales`` /
``v_scales``) take the JAX wrapper's scale handling: ``sm_scale *
k_scale[h]`` is folded into q in fp32 and rounded to q's dtype, and the
scores are scaled by 1. The single-split output is rounded to q's dtype,
multiplied by ``v_scale[h]`` and rounded again (two roundings, as in JAX);
with splits, ``v_scale`` multiplies the fp32 partials before the merge. The
verify path takes the single-split handling on its (B, Hq, T, D) q and
output. The kernel does all of this itself (the scale pointers go to it);
the plain route folds the scales around its attention with torch ops
(:func:`fold_k_scale`, :func:`scale_heads`), in JAX's order.

The single-split forms (decode and verify) take the attention variants of
the JAX kernel: a sliding ``window`` (the query at position ``len - 1``
attends ``[len - window, len)``), attention ``sinks`` (the first ``sinks``
positions stay attendable; they need a window) and a ``softcap``
(``cap * tanh(s / cap)`` on the scaled score, before the mask). The window
is a Python int per call, so a model whose window differs from layer to
layer passes each layer's own. As in JAX, a window or softcap with more
than one split raises ``ValueError``. head_dim is 64, 128 or 256, and on
the card also 640 (MLA's latent row, DeepSeek-V2's 16 query heads on one
latent KV head) for bf16 q and KV, at most 16 query heads a KV head, no
variant and no verify span, at any number of splits (:func:`check_head_dim`).
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.core.reference import NEG_INF, repeat_kv
from starflashattention_tpu_torch.ops import _build
from starflashattention_tpu_torch.ops.cache_append import append_block_kv_plain, append_rows_kv_plain
from starflashattention_tpu_torch.utils.device import sm_count

_SPLIT_SIGNATURES = {
    "flash_decode_split": [_build.P] * 16 + [_build.I] * 11 + [_build.F] + [_build.I] * 6
    + [_build.F, _build.P],
}
_CUDA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
QUANT_KV_DTYPES = {torch.int8: 1, torch.float8_e4m3fn: 2}  # the kernel's kv_dtype codes


def kv_dtype_code(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> int:
    """The kernels' KV element code: 0 for q's own dtype, else int8 / fp8."""
    if kv_dtype == q_dtype:
        return 0
    if kv_dtype not in QUANT_KV_DTYPES:
        raise ValueError(f"the CUDA kernel takes a KV cache in q's dtype ({q_dtype}) or int8 / "
                         f"fp8, got {kv_dtype}")
    return QUANT_KV_DTYPES[kv_dtype]


def scale_heads(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` (B, Hq, ...) times ``scales[h // G]``, the (Hkv,) scale of
    each query head's KV head."""
    hkv = scales.shape[0]
    grouped = x.float().reshape(x.shape[0], hkv, x.shape[1] // hkv, *x.shape[2:])
    return (grouped * scales.float().reshape(1, hkv, *[1] * (x.dim() - 1))).reshape(x.shape)


def fold_k_scale(q: torch.Tensor, sm_scale: float | None, k_scales: torch.Tensor) -> torch.Tensor:
    """q * (sm_scale * k_scale[kv head of each q head]) in fp32, rounded to
    q's dtype (JAX flash_decode.py:400-409). sm_scale is rounded to fp32 on
    the host, so nothing here waits for the device."""
    sm = torch.tensor(1.0 / q.shape[-1]**0.5 if sm_scale is None else sm_scale, dtype=torch.float32)
    return scale_heads(q, k_scales.float() * sm.item()).to(q.dtype)


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


NO_WINDOW = 1 << 30  # the kernels' window without one: every row below the length is in band
KERNEL_HEAD_DIMS = (64, 128, 256)  # the head_dims csrc/flash_decode_split.cu serves in every form
TILE = 32  # KV rows a tile of the decode kernels
SPLIT_MIN_CHUNK = 128  # fewest KV rows a block of the split kernel walks
SPLIT_BLOCKS_PER_SM = 8  # the chunk grid aims at about this many blocks an SM (up to D 256)
LATENT_HEAD_DIM = 640  # MLA's cache row: kv_lora_rank 512 + qk_rope 64, padded to 128 lanes
LATENT_BLOCKS_PER_SM = 1  # a D 640 block takes 229,888 bytes of shared memory: one an SM
LATENT_MAX_GROUP = 16  # query heads a KV head at D 640: one m16 tile of rows


def check_head_dim(what, d, q_dtype, kv_dtype, plain=True, verify=False, group=1):
    """The head_dims the decode kernels take: 64, 128 or 256, and the latent
    row's 640 in its one form (bf16 q and KV, no variant, no verify span, at
    most ``LATENT_MAX_GROUP`` query heads a KV head), at any number of
    splits; raises ``ValueError`` naming what is missing."""
    if d in KERNEL_HEAD_DIMS:
        return
    if d != LATENT_HEAD_DIM:
        raise ValueError(f"{what}: the CUDA kernel takes head_dim 64, 128, 256 or "
                         f"{LATENT_HEAD_DIM}, got {d}")
    if not (q_dtype == kv_dtype == torch.bfloat16 and plain and not verify):
        raise ValueError(f"{what}: head_dim {LATENT_HEAD_DIM} (MLA's latent row) takes bf16 q and KV, "
                         "no window, sinks, softcap or verify span (ROADMAP Queue 2a: K1 verify at "
                         "D 640)")
    if group > LATENT_MAX_GROUP:
        raise ValueError(f"{what}: head_dim {LATENT_HEAD_DIM} takes at most {LATENT_MAX_GROUP} query "
                         f"heads a KV head (one m16 tile of rows), got {group}")


def variant_options(window, sinks, softcap) -> dict:
    """The checked attention variants as keyword arguments of the plain and
    kernel cores: ``window`` (int >= 1 or None), ``sinks`` (needs a window)
    and ``softcap`` (> 0 or None)."""
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if sinks and window is None:
        raise ValueError("attention sinks require a sliding window")
    if sinks < 0:
        raise ValueError(f"sinks must be >= 0, got {sinks}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    return {"window": window, "sinks": int(sinks), "softcap": softcap}


def in_band(kv_pos, lengths, window, sinks):
    """Whether KV position ``kv_pos`` is attended by a query row with
    ``lengths`` valid rows (broadcasting): below the length and, with a
    window, in ``[lengths - window, lengths)`` or a sink."""
    valid = kv_pos < lengths
    if window is not None:
        band = kv_pos >= lengths - window
        if sinks:
            band = band | (kv_pos < sinks)
        valid = valid & band
    return valid


def cap_scores(scores, softcap):
    """Gemma-2's ``cap * tanh(s / cap)`` on scaled scores (identity without)."""
    return scores if softcap is None else softcap * torch.tanh(scores / softcap)


def has_variants(window, sinks, softcap) -> bool:
    """Whether a call takes a window, sinks or a softcap (the split
    kernel's VARIANTS form; the plain form compiles them away)."""
    return window is not None or bool(sinks) or softcap is not None


def kernel_options(window, sinks, softcap) -> tuple[int, int, float]:
    """(window, sinks, softcap) as the CUDA kernels take them."""
    return (NO_WINDOW if window is None else window), sinks, (0.0 if softcap is None else softcap)


def _quantized(k_cache, k_scales, v_scales) -> bool:
    """Whether the cache is int8 / fp8; such a cache needs both scale vectors."""
    if k_cache.dtype not in QUANT_KV_DTYPES:
        return False
    if k_scales is None or v_scales is None:
        raise ValueError(f"a {k_cache.dtype} KV cache needs k_scales and v_scales")
    return True


def check_append(what, q, k_new, v_new, pos, kv_dtype, hkv, d, n_valid=None, span=False):
    """The folded append's inputs as the kernel takes them: ``k_new`` /
    ``v_new`` in the cache's dtype, contiguous and 16-byte aligned, (B,
    Hkv, D) rows for one query token a sequence, q (B, Hq, D) (a verify span
    takes no such append), or with ``span`` (B, Hkv, T, D) rows for q (B,
    Hq, T, D); ``pos`` (B,) integer first write positions; ``n_valid`` (B,)
    integer rows to write, or None. Raises ``ValueError`` on anything else:
    no row is copied to make it fit."""
    if q.dim() != (4 if span else 3):
        raise ValueError(f"{what}: takes q (B, Hq, T, D), got {tuple(q.shape)}" if span else
                         f"{what}: a verify span takes no folded append, q {tuple(q.shape)}")
    b = q.shape[0]
    rows = (b, hkv, *q.shape[2:-1], d)
    for name, new in (("k_new", k_new), ("v_new", v_new)):
        if new.shape != rows or new.dtype != kv_dtype:
            raise ValueError(f"{what}: {name} {tuple(new.shape)} {new.dtype} does not match the "
                             f"cache's {rows} {kv_dtype} rows")
        if not new.is_contiguous() or new.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    for name, x in (("pos", pos), ("n_valid", n_valid)):
        if x is not None and (x.shape != (b,) or x.dtype not in (torch.int32, torch.int64)):
            raise ValueError(f"{what}: {name} must be ({b},) int32, got {tuple(x.shape)} {x.dtype}")


def _as_table(k_cache, v_cache, layer):
    """(B, Hkv, S, D) caches become a one-layer table at layer 0."""
    if k_cache.dim() == 4:
        return k_cache[None], v_cache[None], 0
    if layer is None:
        raise ValueError("layer index required for a (L, ...) cache table")
    return k_cache, v_cache, int(layer)


# ----------------------------------------------------------------- the chunk grid


def split_chunking(s: int, b: int, hkv: int, sms: int, d: int) -> tuple[int, int]:
    """(C, N): the KV rows each block of a merging call of the split kernel
    walks and the chunk count, N = ceil(S / C). C is a multiple of the
    32-row tile, at least ``SPLIT_MIN_CHUNK``, and as small as that allows
    while B * Hkv * N stays near the blocks an SM holds at head_dim ``d``
    (``SPLIT_BLOCKS_PER_SM`` up to D 256, ``LATENT_BLOCKS_PER_SM`` at D
    640). It depends on the table's S, on B * Hkv and on D, never on the
    lengths, so a verify token and the decode at its length see the same
    chunks."""
    per_sm = LATENT_BLOCKS_PER_SM if d == LATENT_HEAD_DIM else SPLIT_BLOCKS_PER_SM
    target = -(-per_sm * sms // (b * hkv))
    c = -(-s // target)
    c = max(SPLIT_MIN_CHUNK, -(-c // TILE) * TILE)
    return c, -(-s // c)


def split_chunk_walk(length: int, *, s: int, chunk: int, qspan: int = 1, window=None,
                     sinks: int = 0) -> list[list[tuple[int, list[int]]]]:
    """Each chunk's walk in ``csrc/flash_decode_split.cu``, as the kernel
    computes it, for a sequence whose token 0 has ``length`` valid rows:
    per chunk, [(tile start, KV rows the tile reads)]. The walk visits the
    sink tiles below the band's first tile, then the band from the tile of
    ``max(length - window, 0)``, up to the last token's length; a chunk
    walks the tiles of its own rows, and a tile reads the rows of its chunk
    that lie in token 0's band or are sinks (the rest stay zero)."""
    end = min(length + qspan - 1, s)
    lo = max(length - (NO_WINDOW if window is None else window), 0)
    band0 = lo // TILE * TILE
    sink_end = -(-min(sinks, band0) // TILE) * TILE

    def skip(j):  # from the last sink tile to the band's first
        return band0 if sink_end <= j < band0 else j

    walks = []
    for cs in range(0, s, chunk):
        ce = min(cs + chunk, end)
        tiles, j = [], skip(cs)
        while j < ce:
            tiles.append((j, [p for p in range(j, j + TILE) if p < ce and (p >= lo or p < sinks)]))
            j = skip(j + TILE)
        walks.append(tiles)
    return walks


_SPLIT_WORKSPACE: dict[tuple[int, int], dict] = {}


def _split_workspace(device, rows, n, d, pairs):
    """fp32 (o, m, l) for ``rows`` query rows of ``n`` chunks at head_dim
    ``d`` and ``pairs`` arrival counters (zeros; the kernel leaves them at
    zero), cached per device and stream and grown when a call needs more.
    The kernel's launches on one stream run in order, so one workspace
    serves them all."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    ws = _SPLIT_WORKSPACE.get(key)
    if (ws is None or ws["o"].numel() < rows * n * d or ws["m"].numel() < rows * n
            or ws["arrivals"].numel() < pairs):
        old_o = 0 if ws is None else ws["o"].numel()
        old_cells = 0 if ws is None else ws["m"].numel()
        old_pairs = 0 if ws is None else ws["arrivals"].numel()
        cells = max(rows * n, old_cells)
        ws = {"o": torch.empty(max(rows * n * d, old_o), dtype=torch.float32, device=device),
              "m": torch.empty(cells, dtype=torch.float32, device=device),
              "l": torch.empty(cells, dtype=torch.float32, device=device),
              "arrivals": torch.zeros(max(pairs, old_pairs), dtype=torch.int32, device=device)}
        _SPLIT_WORKSPACE[key] = ws
    return ws["o"], ws["m"], ws["l"], ws["arrivals"]


def _scale_vectors(scales, hkv, device):
    """The (Hkv,) fp32 k / v scale vectors of a quantized call as the
    kernel reads them (no copy when they already are), or (None, None)."""
    if scales is None:
        return None, None
    out = []
    for x in scales:
        if x.shape != (hkv,):
            raise ValueError(f"KV scales must have shape ({hkv},), got {tuple(x.shape)}")
        out.append(x.to(device=device, dtype=torch.float32).contiguous())
    return tuple(out)


def launch_split(q, k_ptr, v_ptr, lengths, *, hkv, s, scale, kv_code, scales=None, out=None,
                 parts=None, split_len=None, pages=None, window=None, sinks=0, softcap=None,
                 append=None):
    """Launch ``csrc/flash_decode_split.cu`` on checked, contiguous inputs:
    q (B, Hq, D) or (B, Hq, T, D), one layer's K/V pointers, int32 lengths,
    ``scales`` = (k_scales, v_scales) on a quantized cache. Merging mode
    (``out``, q's shape): the chunk grid of :func:`split_chunking` on the
    cached workspace, one launch. Partials mode (``parts`` = (o, m, l),
    ``split_len``): the caller's split geometry. ``pages`` =
    (page_table, num_pages, page_size) selects the paged form, which folds
    ``scale`` into q and rounds it to q's dtype. ``append`` = (k_new, v_new,
    wpos, n_valid), checked by :func:`check_append`, folds the step's row
    append into the launch: the decode's one row, or a verify span's T rows
    of which the first ``n_valid`` (None: all) are written (wpos and
    n_valid of any integer dtype, taken to int32 on q's device here; the
    kernel clamps wpos to S - T)."""
    b, hq = q.shape[:2]
    d = q.shape[-1]
    qspan = q.shape[2] if q.dim() == 4 else 1
    if out is not None:
        chunk, n = split_chunking(s, b, hkv, sm_count(q.device), d)
        o, m, l, arrivals = _split_workspace(q.device, b * hq * qspan, n, d, b * hkv)
    else:
        (o, m, l), arrivals = parts, None
        chunk, n = split_len, o.shape[2]
    table, num_pages, page_size = pages if pages is not None else (None, 0, 1)
    k_scales, v_scales = _scale_vectors(scales, hkv, q.device)
    k_new, v_new, wpos, n_valid = append if append is not None else (None,) * 4
    wpos, n_valid = (None if x is None else x.to(device=q.device, dtype=torch.int32).contiguous()
                     for x in (wpos, n_valid))
    lib = _build.load("flash_decode_split", _SPLIT_SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_decode_split(
            _build.ptr(q), k_ptr, v_ptr, _build.ptr(lengths),
            None if table is None else _build.ptr(table), None if out is None else _build.ptr(out),
            _build.ptr(o), _build.ptr(m), _build.ptr(l),
            None if arrivals is None else _build.ptr(arrivals),
            None if k_scales is None else _build.ptr(k_scales),
            None if v_scales is None else _build.ptr(v_scales),
            *(None if t is None else _build.ptr(t) for t in (k_new, v_new, wpos, n_valid)),
            b, hq, hkv, s, d, qspan, chunk, n, 0 if table is None else table.shape[1], page_size,
            num_pages, scale, _CUDA_DTYPES[q.dtype], kv_code, int(table is not None),
            int(has_variants(window, sinks, softcap)), *kernel_options(window, sinks, softcap),
            _build.stream_ptr(q.device),
        )
    _build.check(lib, err, "flash_decode_split")


# ----------------------------------------------------------------- plain versions


def _scores(q, k_layer, lengths, sm_scale, window=None, sinks=0, softcap=None):
    """fp32 scores (B, Hq, S), capped, and the validity mask of one layer."""
    b, hq, d = q.shape
    hkv, s = k_layer.shape[1], k_layer.shape[2]
    k = repeat_kv(k_layer, hq // hkv).float()
    scale = 1.0 / d**0.5 if sm_scale is None else sm_scale
    scores = cap_scores(torch.einsum("bhd,bhkd->bhk", q.float(), k) * scale, softcap)
    kv_pos = torch.arange(s, device=q.device)[None, None, :]
    mask = in_band(kv_pos, lengths.to(q.device)[:, None, None], window, sinks)
    return scores, mask


def _stats_plain(q, k_cache, v_cache, lengths, *, layer=None, sm_scale=None, num_splits=4,
                 block_k=256):
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


def _fused_plain(q, k_cache, v_cache, lengths, *, layer, sm_scale, window=None, sinks=0,
                 softcap=None):
    """Plain single-split decode attention -> (B, Hq, D) in q's dtype; a
    (B, Hq, T, D) q is the verify mode: token j is a decode at ``lengths +
    j``, computed by the same function, so row for row the same numbers."""
    opts = dict(window=window, sinks=sinks, softcap=softcap)
    if q.dim() == 4:
        return torch.stack([_fused_plain(q[:, :, j], k_cache, v_cache, lengths + j, layer=layer,
                                         sm_scale=sm_scale, **opts) for j in range(q.shape[2])],
                           dim=2)
    scores, mask = _scores(q, k_cache[layer], lengths, sm_scale, **opts)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1, keepdim=True)
    v = repeat_kv(v_cache[layer], q.shape[1] // v_cache.shape[2]).float()
    o = torch.einsum("bhk,bhkd->bhd", p, v) / torch.where(l == 0, torch.ones_like(l), l)
    return o.to(q.dtype)


def flash_decode_with_stats_plain(q, k_cache, v_cache, lengths, *, layer=None, sm_scale=None,
                                  num_splits=4, block_k=256, k_scales=None, v_scales=None):
    """Plain twin of :func:`flash_decode_with_stats` (quantized caches
    included)."""
    return _decode(q, k_cache, v_cache, lengths, layer, sm_scale, num_splits, block_k, k_scales,
                   v_scales, None, _stats_plain, partials=True)


def flash_decode_plain(q, k_cache, v_cache, lengths, *, layer=None, sm_scale=None,
                       num_splits=4, block_k=256, k_scales=None, v_scales=None, window=None,
                       sinks=0, softcap=None):
    """Plain PyTorch decode attention -> (B, Hq, D) in q's dtype (quantized
    caches and the variants included). A row of length 0 gives 0."""
    return _decode(q, k_cache, v_cache, lengths, layer, sm_scale, num_splits, block_k, k_scales,
                   v_scales, _fused_plain, _stats_plain, opts=variant_options(window, sinks, softcap))


def flash_decode_append_plain(q, k_cache, v_cache, k_new, v_new, pos, lengths, *, layer=None,
                              sm_scale=None, num_splits=4, block_k=256, k_scales=None,
                              v_scales=None, window=None, sinks=0, softcap=None):
    """Plain twin of :func:`flash_decode_append`: :func:`append_rows_kv_plain`
    at ``min(pos, S - 1)``, then :func:`flash_decode_plain`."""
    k_cache, v_cache, layer = _as_table(k_cache, v_cache, layer)
    append_rows_kv_plain(k_cache, v_cache, k_new, v_new, layer,
                         torch.clamp(pos, max=k_cache.shape[3] - 1))
    return flash_decode_plain(q, k_cache, v_cache, lengths, layer=layer, sm_scale=sm_scale,
                              num_splits=num_splits, block_k=block_k, k_scales=k_scales,
                              v_scales=v_scales, window=window, sinks=sinks, softcap=softcap)


def _decode(q, k_cache, v_cache, lengths, layer, sm_scale, num_splits, block_k, k_scales,
            v_scales, fused, stats, partials=False, opts=None, kernel=False, append=None):
    """The wrapper logic shared by the kernel and the plain route: the split
    choice and, for a quantized cache, the scales around ``fused`` /
    ``stats`` (functions of q, tables, lengths, layer=, sm_scale=[,
    num_splits=, block_k=]; ``fused`` also takes the variant ``opts``). On
    the ``kernel`` route both take ``scales=`` (k_scales, v_scales) or None
    and apply them in the kernel; on the plain route they are folded around
    the call in JAX's order. A window or softcap needs one split, as in
    JAX. ``append`` (kernel route only) is the folded append's (k_new,
    v_new, pos, n_valid), handed to whichever launch runs."""
    k_cache, v_cache, layer = _as_table(k_cache, v_cache, layer)
    opts = opts or variant_options(None, 0, None)
    n = _split_geometry(k_cache.shape[3], num_splits, block_k)[0]
    if n != 1:
        if opts["window"] is not None:
            raise ValueError("sliding-window attention requires num_splits=1 (the fused kernel); "
                             "splitting a windowed band across the cache buys nothing")
        if opts["softcap"] is not None:
            raise ValueError("attention softcapping requires num_splits=1 (the fused kernel); "
                             "use num_splits=1 for Gemma-2-class models")
    quantized = _quantized(k_cache, k_scales, v_scales)
    if kernel:
        kw = dict(layer=layer, sm_scale=sm_scale, scales=(k_scales, v_scales) if quantized else None,
                  append=append)
        if n == 1 and not partials:
            return fused(q, k_cache, v_cache, lengths, **kw, **opts)
        o, m, l = stats(q, k_cache, v_cache, lengths, num_splits=num_splits, block_k=block_k, **kw)
        return (o, m, l) if partials else lse_combine_splits(o, m, l, dtype=q.dtype)
    if quantized:
        q, sm_scale = fold_k_scale(q, sm_scale, k_scales), 1.0
    else:
        v_scales = None
    if n == 1 and not partials:
        o = fused(q, k_cache, v_cache, lengths, layer=layer, sm_scale=sm_scale, **opts)
        if v_scales is not None:  # the second rounding, as in JAX
            o = scale_heads(o, v_scales).to(q.dtype)
        return o
    o, m, l = stats(q, k_cache, v_cache, lengths, layer=layer, sm_scale=sm_scale,
                    num_splits=num_splits, block_k=block_k)
    if v_scales is not None:  # linear in the partials: commutes with the merge
        o = scale_heads(o, v_scales)
    return (o, m, l) if partials else lse_combine_splits(o, m, l, dtype=q.dtype)


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


def _launch(q, k_cache, v_cache, lengths, layer, sm_scale, n, split_len, fused, scales=None,
            window=None, sinks=0, softcap=None, append=None):
    """Run csrc/flash_decode_split.cu on one layer of the table; returns the
    normalized output (fused; q (B, Hq, D), or (B, Hq, T, D) to verify) or
    the (o, m, l) partials. ``append`` = (k_new, v_new, pos, n_valid): the
    folded row append."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    l_, b, hkv, s, d = k_cache.shape
    hq = q.shape[1]
    qspan = q.shape[2] if q.dim() == 4 else 1
    if q.shape != ((b, hq, qspan, d) if q.dim() == 4 else (b, hq, d)) or hq % hkv or qspan < 1:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}")
    if qspan > 1 and not fused:
        raise ValueError("the verify span takes the single-split (fused) mode only")
    if q.dtype not in _CUDA_DTYPES or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"the CUDA kernel takes fp32 or bf16 q and one cache dtype, got "
                         f"{q.dtype} / {k_cache.dtype} / {v_cache.dtype}")
    kv_code = kv_dtype_code(q.dtype, k_cache.dtype)
    check_head_dim("flash_decode", d, q.dtype, k_cache.dtype, not has_variants(window, sinks, softcap),
                   qspan > 1, hq // hkv)
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
    launch_split(q, k_ptr, v_ptr, lengths, hkv=hkv, s=s, scale=scale, kv_code=kv_code,
                 scales=scales, out=out, parts=None if fused else parts, split_len=split_len,
                 window=window, sinks=sinks, softcap=softcap, append=append)
    return out if fused else parts


def _count_launch(append):
    flash_decode.launches += 1
    if append is not None:
        flash_decode_append.launches += 1


def _fused_kernel(q, k_cache, v_cache, lengths, *, layer, sm_scale, scales, append=None, **opts):
    s = k_cache.shape[3]
    out = _launch(q, k_cache, v_cache, lengths, layer, sm_scale, 1, s, fused=True, scales=scales,
                  append=append, **opts)
    _count_launch(append)
    if opts["window"] is not None and opts["window"] < s:
        flash_decode.launches_banded += 1
    return out


def _stats_kernel(q, k_cache, v_cache, lengths, *, layer, sm_scale, num_splits, block_k, scales,
                  append=None):
    s = k_cache.shape[3]
    n, _, _ = _split_geometry(s, num_splits, block_k)
    parts = _launch(q, k_cache, v_cache, lengths, layer, sm_scale, n, s // n, fused=False,
                    scales=scales, append=append)
    _count_launch(append)
    return parts


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
    k_scales: torch.Tensor | None = None,  # (Hkv,) fp32 for an int8 / fp8 cache
    v_scales: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split-KV decode -> unnormalized ``o`` (B, Hq, N, D) (times v_scale
    for a quantized cache) and natural-log ``m``, ``l`` (B, Hq, N), all
    fp32."""
    if q.device.type == "cpu":
        return flash_decode_with_stats_plain(
            q, k_cache, v_cache, lengths, layer=layer, sm_scale=sm_scale,
            num_splits=num_splits, block_k=block_k, k_scales=k_scales, v_scales=v_scales)
    return _decode(q, k_cache, v_cache, lengths, layer, sm_scale, num_splits, block_k, k_scales,
                   v_scales, None, _stats_kernel, partials=True, kernel=True)


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
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    max_len_hint: int | None = None,
    window=None,
    sinks: int = 0,
    softcap: float | None = None,
) -> torch.Tensor:
    """Decode attention: (B, Hq, D) query vs a (B, Hkv, S, D) cache — or a
    whole (L, B, Hkv, S, D) table plus ``layer`` — -> (B, Hq, D) in q's
    dtype. When the split geometry gives one split, the kernel normalizes in
    place; otherwise it writes partials and :func:`lse_combine_splits`
    merges them. An int8 / fp8 cache needs its (Hkv,) ``k_scales`` and
    ``v_scales`` (see the module doc). ``window``, ``sinks`` and ``softcap``
    take one split. ``max_len_hint`` sizes the TPU grid and is unused (each
    block walks its own row's length). Each launch (either mode) counts once
    in ``flash_decode.launches``, and once more in ``launches_banded`` when
    its window is narrower than the table (a sliding layer's band)."""
    del max_len_hint
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths, layer=layer, sm_scale=sm_scale,
                                  num_splits=num_splits, block_k=block_k, k_scales=k_scales,
                                  v_scales=v_scales, window=window, sinks=sinks, softcap=softcap)
    return _decode(q, k_cache, v_cache, lengths, layer, sm_scale, num_splits, block_k, k_scales,
                   v_scales, _fused_kernel, _stats_kernel,
                   opts=variant_options(window, sinks, softcap), kernel=True)


flash_decode.launches = 0
flash_decode.launches_banded = 0  # those whose window band is narrower than the table


def flash_decode_append(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, Hkv, S, D) or (L, B, Hkv, S, D) with `layer`
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # (B, Hkv, D) in the cache's dtype, contiguous, 16-byte aligned
    v_new: torch.Tensor,
    pos: torch.Tensor,  # (B,) int32 write positions, clamped to S - 1
    lengths: torch.Tensor,  # (B,) int32 attended rows, the new one included
    *,
    layer: int | None = None,
    sm_scale: float | None = None,
    num_splits: int = 4,
    block_k: int = 256,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    window=None,
    sinks: int = 0,
    softcap: float | None = None,
) -> torch.Tensor:
    """The decode step's append and attention in one launch: writes
    ``table[layer, b, :, min(pos[b], S - 1)] = new[b]`` for K and V IN
    PLACE, then returns :func:`flash_decode` over ``lengths`` -> (B, Hq, D),
    bit for bit ``append_rows_kv`` followed by ``flash_decode`` (the kernel
    writes the row from the block whose chunk holds it and reads it from
    the new rows; see ``csrc/flash_decode_split.cu``). A quantized cache
    takes its rows already quantized. ``pos`` and ``lengths`` are never
    read back to the host. Each launch counts in ``flash_decode.launches``
    and in ``flash_decode_append.launches``. Raises ``ValueError`` on rows
    the kernel does not take (:func:`check_append`) on either route."""
    k_tab, _, _ = _as_table(k_cache, v_cache, layer)
    check_append("flash_decode_append", q, k_new, v_new, pos, k_tab.dtype, k_tab.shape[2], k_tab.shape[4])
    if q.device.type == "cpu":
        return flash_decode_append_plain(q, k_cache, v_cache, k_new, v_new, pos, lengths, layer=layer,
                                         sm_scale=sm_scale, num_splits=num_splits, block_k=block_k,
                                         k_scales=k_scales, v_scales=v_scales, window=window,
                                         sinks=sinks, softcap=softcap)
    return _decode(q, k_cache, v_cache, lengths, layer, sm_scale, num_splits, block_k, k_scales,
                   v_scales, _fused_kernel, _stats_kernel,
                   opts=variant_options(window, sinks, softcap), kernel=True,
                   append=(k_new, v_new, pos, None))


flash_decode_append.launches = 0  # the launches that folded an append (all also in flash_decode's)


# ----------------------------------------------------------------- verify


def _verify_kernel(q, k_cache, v_cache, lengths, *, layer, sm_scale, scales, append=None, **opts):
    s = k_cache.shape[3]
    out = _launch(q, k_cache, v_cache, lengths, layer, sm_scale, 1, s, fused=True, scales=scales,
                  append=append, **opts)
    flash_verify.launches += 1
    if append is not None:
        flash_verify_append.launches += 1
    return out


def flash_verify_plain(q, k_cache, v_cache, lengths, *, layer=None, sm_scale=None, block_k=256,
                       k_scales=None, v_scales=None, window=None, sinks=0, softcap=None):
    """Plain twin of :func:`flash_verify`: token j is :func:`flash_decode_plain`
    (one split) at ``lengths + j``, exactly."""
    _check_span(q)
    return _decode(q, k_cache, v_cache, lengths, layer, sm_scale, 1, block_k, k_scales, v_scales,
                   _fused_plain, None, opts=variant_options(window, sinks, softcap))


def _check_span(q):
    if q.dim() != 4:
        raise ValueError(f"flash_verify takes q (B, Hq, T, D), got {tuple(q.shape)}")


def flash_verify(
    q: torch.Tensor,  # (B, Hq, T, D): T consecutive query tokens per sequence
    k_cache: torch.Tensor,  # (B, Hkv, S, D) or (L, B, Hkv, S, D) with `layer`
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32 — valid KV for query token 0 (incl. its row)
    *,
    layer: int | None = None,
    sm_scale: float | None = None,
    block_k: int = 256,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    max_len_hint: int | None = None,
    window=None,
    sinks: int = 0,
    softcap: float | None = None,
) -> torch.Tensor:
    """Multi-query decode attention for speculative decoding's verify step
    (JAX ``flash_verify``): ``q[:, :, j]`` is the query at absolute position
    ``lengths[b] - 1 + j`` and attends KV positions ``< lengths[b] + j``.
    Returns (B, Hq, T, D) in q's dtype. Always one split (the JAX op has
    none); an int8 / fp8 cache folds its scales as :func:`flash_decode`
    does; ``window``, ``sinks`` and ``softcap`` as in :func:`flash_decode`
    (token j's band ends at ``lengths[b] + j``). ``max_len_hint`` sizes the
    TPU grid and is unused. Each launch counts once in
    ``flash_verify.launches``."""
    del max_len_hint
    _check_span(q)
    kernel = q.device.type != "cpu"
    return _decode(q, k_cache, v_cache, lengths, layer, sm_scale, 1, block_k, k_scales, v_scales,
                   _verify_kernel if kernel else _fused_plain, None,
                   opts=variant_options(window, sinks, softcap), kernel=kernel)


flash_verify.launches = 0


def flash_verify_append_plain(q, k_cache, v_cache, k_new, v_new, pos, n_valid, lengths, *, layer=None,
                              sm_scale=None, block_k=256, k_scales=None, v_scales=None, window=None,
                              sinks=0, softcap=None):
    """Plain twin of :func:`flash_verify_append`: :func:`append_block_kv_plain`
    at ``min(pos, S - T)`` with ``n_valid``, then :func:`flash_verify_plain`."""
    k_cache, v_cache, layer = _as_table(k_cache, v_cache, layer)
    append_block_kv_plain(k_cache, v_cache, k_new, v_new, layer,
                          torch.clamp(pos, max=k_cache.shape[3] - q.shape[2]), n_valid)
    return flash_verify_plain(q, k_cache, v_cache, lengths, layer=layer, sm_scale=sm_scale,
                              block_k=block_k, k_scales=k_scales, v_scales=v_scales, window=window,
                              sinks=sinks, softcap=softcap)


def flash_verify_append(
    q: torch.Tensor,  # (B, Hq, T, D)
    k_cache: torch.Tensor,  # (B, Hkv, S, D) or (L, B, Hkv, S, D) with `layer`
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # (B, Hkv, T, D) in the cache's dtype, contiguous, 16-byte aligned
    v_new: torch.Tensor,
    pos: torch.Tensor,  # (B,) int32 first write positions, clamped to S - T
    n_valid: torch.Tensor | None,  # (B,) int32 rows to write (None: all T; 0: an inactive row)
    lengths: torch.Tensor,  # (B,) int32 valid KV for query token 0
    *,
    layer: int | None = None,
    sm_scale: float | None = None,
    block_k: int = 256,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    window=None,
    sinks: int = 0,
    softcap: float | None = None,
) -> torch.Tensor:
    """The verify step's block append and attention in one launch: writes
    ``table[layer, b, :, p + j] = new[b, :, j]`` for ``j < n_valid[b]`` at
    ``p = min(pos[b], S - T)`` for K and V IN PLACE (rows outside the
    table skipped), then returns :func:`flash_verify` over ``lengths`` ->
    (B, Hq, T, D), bit for bit ``append_block_kv`` followed by
    ``flash_verify`` (the blocks whose chunks hold the span's rows write
    them and read them from the new rows; see ``csrc/flash_decode_split.cu``).
    A quantized cache takes its rows already quantized. ``pos``,
    ``n_valid`` and ``lengths`` are never read back to the host. Each
    launch counts in ``flash_verify.launches`` and in
    ``flash_verify_append.launches``. Raises ``ValueError`` on rows the
    kernel does not take (:func:`check_append`) on either route."""
    k_tab, _, _ = _as_table(k_cache, v_cache, layer)
    check_append("flash_verify_append", q, k_new, v_new, pos, k_tab.dtype, k_tab.shape[2], k_tab.shape[4],
                 n_valid=n_valid, span=True)
    if q.device.type == "cpu":
        return flash_verify_append_plain(q, k_cache, v_cache, k_new, v_new, pos, n_valid, lengths,
                                         layer=layer, sm_scale=sm_scale, block_k=block_k,
                                         k_scales=k_scales, v_scales=v_scales, window=window,
                                         sinks=sinks, softcap=softcap)
    return _decode(q, k_cache, v_cache, lengths, layer, sm_scale, 1, block_k, k_scales, v_scales,
                   _verify_kernel, None, opts=variant_options(window, sinks, softcap), kernel=True,
                   append=(k_new, v_new, pos, n_valid))


flash_verify_append.launches = 0  # the launches that folded an append (all also in flash_verify's)
