"""Paged KV-cache pool: physical pages + per-sequence page tables — twin of
the JAX ``cache/paged.py``.

Layout: ``k_pages``/``v_pages`` are (L, Hkv, num_pages, page_size, D), so
one (layer, head, page) is a contiguous (page_size, D) tile.
``page_table`` is (B, pages_per_seq) int32 of physical page ids on the
device; the allocators below are host-side bookkeeping that produce it.
Page 0 is the null page: fresh table rows point at it, so a kernel may
read or write through an unmapped entry without leaving the pool.

Quantized pools hold int8 / fp8 values with per-(layer, KV head) fp32
scales fixed at allocation, as the contiguous cache does.

The port updates the pools IN PLACE (the JAX package donates them to its
jitted step instead). :func:`append_decode_paged` goes through the K8
kernel (``ops/cache_append.append_rows_paged_kv``);
:func:`append_decode_attend_paged`, the decode step's, folds that append
into the paged decode's launch (``ops/paged_decode.
paged_flash_decode_append``); the prompt-chunk
scatter and the prefix gather are plain tensor indexing, as they are XLA
ops outside any Pallas kernel in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from starflashattention_tpu_torch.cache.contiguous import kv_storage, quantize_new
from starflashattention_tpu_torch.ops.cache_append import append_rows_paged_kv
from starflashattention_tpu_torch.ops.paged_decode import paged_flash_decode_append
from starflashattention_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PagedKVCache:
    """``k_pages``/``v_pages``: (L, Hkv, P, page_size, D) bf16/fp32, or
    int8/float8_e4m3fn when quantized; ``page_table``: (B, pages_per_seq)
    int32; ``lengths``: (B,) int32. ``k_scales``/``v_scales``: (L, Hkv)
    fp32 or None."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    k_scales: torch.Tensor | None = None
    v_scales: torch.Tensor | None = None

    @property
    def num_layers(self) -> int:
        return self.k_pages.shape[0]

    @property
    def num_kv_heads(self) -> int:
        return self.k_pages.shape[1]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[2]

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def head_dim(self) -> int:
        return self.k_pages.shape[4]

    @property
    def batch_size(self) -> int:
        return self.page_table.shape[0]

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]

    @property
    def quant_mode(self) -> str:
        if self.k_pages.dtype == torch.int8:
            return "int8"
        if self.k_pages.dtype == torch.float8_e4m3fn:
            return "fp8"
        return "none"

    def layer_scales(self, layer: int):
        """(k_scales, v_scales) (Hkv,) of one layer, or (None, None)."""
        if self.k_scales is None:
            return None, None
        return self.k_scales[layer], self.v_scales[layer]


def init_paged_cache(
    num_layers: int,
    batch_size: int,
    num_kv_heads: int,
    head_dim: int,
    *,
    num_pages: int,
    page_size: int = 128,
    pages_per_seq: int,
    dtype: torch.dtype = torch.bfloat16,
    quant_mode: str = "none",
    calibration_scale: float = 1.0,
    device: torch.device | str | None = None,
) -> PagedKVCache:
    """Zeroed pools, a null page table and zero lengths on ``device``
    (default ``cuda``). ``quant_mode`` "int8" / "fp8" allocates 1-byte pools
    with per-head scales of ``calibration_scale / qmax``."""
    dev = resolve_device(device)
    if quant_mode == "none" and dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"paged pools hold bf16 or fp32, got {dtype}")
    qdtype, k_scales, v_scales = kv_storage(quant_mode, dtype, num_layers, num_kv_heads,
                                            calibration_scale, dev)
    shape = (num_layers, num_kv_heads, num_pages, page_size, head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=qdtype, device=dev),
        v_pages=torch.zeros(shape, dtype=qdtype, device=dev),
        page_table=torch.zeros((batch_size, pages_per_seq), dtype=torch.int32, device=dev),
        lengths=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        k_scales=k_scales,
        v_scales=v_scales,
    )


class PageAllocator:
    """Host-side free-list allocator for physical pages. Page 0 is reserved
    as the null page and never handed out."""

    NULL_PAGE = 0

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, 0, -1))  # stack, excludes 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"paged KV pool exhausted: want {n}, free {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            if p != self.NULL_PAGE:
                self._free.append(int(p))

    def pages_needed(self, length: int, page_size: int) -> int:
        return -(-length // page_size)


class SeqPagePool:
    """Per-sequence page allocator on :class:`PageAllocator`: the pure-Python
    twin of ``utils.native.NativePagePool`` (same handle API and the same
    allocation order)."""

    def __init__(self, num_pages: int):
        self._alloc = PageAllocator(num_pages)
        self.num_pages = num_pages
        self._seqs: dict[int, list[int]] = {}
        self._next = 1

    @property
    def free_pages(self) -> int:
        return self._alloc.free_pages

    def seq_new(self) -> int:
        h = self._next
        self._next += 1
        self._seqs[h] = []
        return h

    def seq_extend(self, handle: int, new_len: int, page_size: int) -> int:
        pages = self._seqs[handle]
        need = self._alloc.pages_needed(new_len, page_size)
        if need > len(pages):
            pages.extend(self._alloc.alloc(need - len(pages)))
        return len(pages)

    def seq_pages(self, handle: int) -> list[int]:
        return list(self._seqs[handle])

    def seq_free(self, handle: int) -> None:
        self._alloc.free(self._seqs.pop(handle))

    def seq_release_prefix(self, handle: int, n: int) -> list[int]:
        """Detach the handle's first ``n`` pages WITHOUT freeing them (the
        prefix cache takes ownership); the handle keeps its tail."""
        pages = self._seqs[handle]
        if n > len(pages):
            raise ValueError(f"handle owns {len(pages)} pages, cannot release {n}")
        head, self._seqs[handle] = pages[:n], pages[n:]
        return head

    def free_raw(self, pages) -> None:
        """Return loose pages (detached, later evicted) to the allocator."""
        self._alloc.free(pages)


def append_decode_paged(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                        v_new: torch.Tensor) -> PagedKVCache:
    """Write one token's K/V rows (B, Hkv, D) at each sequence's
    ``lengths[b]`` through its page table, IN PLACE (kernel K8). Positions
    clamp to the last logical slot, as the JAX decode step clamps them.
    ``lengths`` is not advanced. Quantized pools get the rows quantized
    against their scales first."""
    ks, vs = cache.layer_scales(layer)
    pos = torch.clamp(cache.lengths, max=cache.pages_per_seq * cache.page_size - 1)
    append_rows_paged_kv(cache.k_pages, cache.v_pages, quantize_new(k_new, ks, cache.k_pages.dtype),
                         quantize_new(v_new, vs, cache.v_pages.dtype), layer, cache.page_table, pos)
    return cache


def append_decode_attend_paged(cache: PagedKVCache, layer: int, q: torch.Tensor,
                               k_new: torch.Tensor, v_new: torch.Tensor, lengths: torch.Tensor, *,
                               sm_scale=None, **opts) -> torch.Tensor:
    """:func:`append_decode_paged` and the paged decode attention over
    ``lengths`` in one launch (K7 with K8 folded in,
    ``ops.paged_decode.paged_flash_decode_append``): the rows (B, Hkv, D)
    go to each sequence's ``lengths[b]`` slot through its page table
    (clamped to the last logical slot), IN PLACE, quantized against the
    pools' scales first; returns (B, Hq, D). ``opts``: the attention
    variants. ``cache.lengths`` is not advanced."""
    ks, vs = cache.layer_scales(layer)
    return paged_flash_decode_append(
        q, cache.k_pages, cache.v_pages, cache.page_table,
        quantize_new(k_new, ks, cache.k_pages.dtype).contiguous(),
        quantize_new(v_new, vs, cache.v_pages.dtype).contiguous(), cache.lengths, lengths,
        layer=layer, sm_scale=sm_scale, k_scales=ks, v_scales=vs, **opts)


@dataclasses.dataclass
class ChunkIndex:
    """Where the valid tokens of a (B, Sq) prompt chunk land in the pool:
    token ``t[i]`` of row ``b[i]`` goes to row ``slot[i]`` of page
    ``phys[i]``."""

    b: torch.Tensor
    t: torch.Tensor
    phys: torch.Tensor
    slot: torch.Tensor


def chunk_index(page_table: torch.Tensor, start: torch.Tensor, new_lengths: torch.Tensor,
                sq: int, page_size: int) -> ChunkIndex:
    """Pool addresses of positions ``start[b] .. start[b] + new_lengths[b]``
    of every row; rows with ``new_lengths == 0`` contribute none. Selecting
    the valid tokens reads their count back to the host (one sync), so a
    prefill computes this once and reuses it for every layer."""
    pages_per_seq = page_table.shape[1]
    tok = torch.arange(sq, device=start.device)
    valid = tok[None, :] < new_lengths.to(start.device)[:, None]
    b, t = valid.nonzero(as_tuple=True)
    pos = start.long()[b] + t
    logical = torch.clamp(pos // page_size, max=pages_per_seq - 1)
    phys = page_table.long()[b, logical]
    return ChunkIndex(b=b, t=t, phys=phys, slot=pos % page_size)


def scatter_prefill_chunk(
    pages: torch.Tensor,  # (L, Hkv, P, page_size, D), one pool
    layer: int,
    vals: torch.Tensor,  # (B, Hkv, Sq, D) chunk, already in the pool dtype
    page_table: torch.Tensor,  # (B, pages_per_seq) int32
    start: torch.Tensor,  # (B,) write offset per sequence
    new_lengths: torch.Tensor,  # (B,) tokens valid in this chunk per sequence
    index: ChunkIndex | None = None,
) -> torch.Tensor:
    """Write positions ``start .. start + new_lengths`` of each row into the
    pool, IN PLACE; rows with ``new_lengths == 0`` write nothing (the JAX
    package's ``mode="drop"``). ``index`` (from :func:`chunk_index`) skips
    recomputing the addresses."""
    if index is None:
        index = chunk_index(page_table, start, new_lengths, vals.shape[2], pages.shape[3])
    # (N, Hkv, D) values -> the (Hkv, N, D) block the page/slot indices address
    pages[int(layer)][:, index.phys, index.slot] = vals[index.b, :, index.t].transpose(0, 1).to(pages.dtype)
    return pages


def gather_prefix(
    pages: torch.Tensor,  # (L, Hkv, P, page_size, D), one pool
    layer: int,
    page_table: torch.Tensor,  # (B, pages_per_seq) int32
    prefix_len: int,
) -> torch.Tensor:
    """Each sequence's first ``prefix_len`` pooled positions as a contiguous
    (B, Hkv, prefix_len, D) tensor (a copy), KV index == absolute
    position."""
    _, hkv, _, ps, d = pages.shape
    b = page_table.shape[0]
    n_pages = -(-prefix_len // ps)
    ids = page_table[:, :n_pages].long().reshape(-1)  # (B * n)
    g = pages[int(layer)][:, ids]  # (Hkv, B * n, ps, D)
    g = g.reshape(hkv, b, n_pages * ps, d).transpose(0, 1)
    return g[:, :, :prefix_len].contiguous()


def gather_layer(cache: PagedKVCache, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A dense (B, Hkv, S, D) copy of one layer through the page table —
    for tests only (the kernels read pages in place)."""
    s = cache.pages_per_seq * cache.page_size
    return (gather_prefix(cache.k_pages, layer, cache.page_table, s),
            gather_prefix(cache.v_pages, layer, cache.page_table, s))
