"""Contiguous multi-layer KV-cache tables — twin of the JAX ``cache/contiguous.py``.

Layers stack on one leading axis: ``k``/``v`` are (L, B, Hkv, S, D). The
port updates these tensors IN PLACE (the JAX package donates the cache to
its jitted step instead); the ops in ``ops/`` take the whole table plus a
``layer`` index, so no per-layer copy is ever made.

Quantized caches hold int8 / fp8 values with per-(layer, KV head) fp32
scales fixed at allocation (calibration), so appended rows quantize against
the existing scales without a rescan (``core/quant.quantize_value``).
"""

from __future__ import annotations

import dataclasses

import torch

from starflashattention_tpu_torch.core import quant
from starflashattention_tpu_torch.ops.cache_append import append_rows_kv
from starflashattention_tpu_torch.ops.flash_decode import flash_decode_append
from starflashattention_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class KVCache:
    """``k``/``v``: (L, B, Hkv, S, D) — bf16/fp32, or int8/float8_e4m3fn when
    quantized. ``lengths``: (B,) int32 valid positions per sequence, shared
    by all layers. ``k_scales``/``v_scales``: (L, Hkv) fp32 or None."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scales: torch.Tensor | None = None
    v_scales: torch.Tensor | None = None

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def batch_size(self) -> int:
        return self.k.shape[1]

    @property
    def num_kv_heads(self) -> int:
        return self.k.shape[2]

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[3]

    @property
    def head_dim(self) -> int:
        return self.k.shape[4]

    @property
    def quant_mode(self) -> str:
        if self.k.dtype == torch.int8:
            return "int8"
        if self.k.dtype == torch.float8_e4m3fn:
            return "fp8"
        return "none"

    def layer_scales(self, layer: int):
        """(k_scales, v_scales) (Hkv,) of one layer, or (None, None)."""
        if self.k_scales is None:
            return None, None
        return self.k_scales[layer], self.v_scales[layer]


def kv_storage(quant_mode: str, dtype: torch.dtype, num_layers: int, num_kv_heads: int,
               calibration_scale: float, device: torch.device):
    """(element dtype, k_scales, v_scales) of a cache: ``dtype`` and no
    scales unquantized, else int8 / fp8 with (L, Hkv) scales of
    ``calibration_scale / qmax``."""
    if quant_mode == "none":
        return dtype, None, None
    if quant_mode not in ("int8", "fp8"):
        raise ValueError(f"unknown KV quant mode {quant_mode!r}")
    qdtype = torch.int8 if quant_mode == "int8" else torch.float8_e4m3fn
    qmax = quant.INT8_MAX if quant_mode == "int8" else quant.FP8_MAX
    scales = torch.full((num_layers, num_kv_heads), calibration_scale / qmax,
                        dtype=torch.float32, device=device)
    return qdtype, scales, scales.clone()


def init_cache(
    num_layers: int,
    batch_size: int,
    num_kv_heads: int,
    max_seq_len: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    quant_mode: quant.QuantMode = "none",
    calibration_scale: float = 1.0,
    device: torch.device | str | None = None,
) -> KVCache:
    """Allocate an empty (zeroed) cache on ``device`` (default ``cuda``).
    Quantized modes get per-head scales of ``calibration_scale / qmax``."""
    dev = resolve_device(device)
    shape = (num_layers, batch_size, num_kv_heads, max_seq_len, head_dim)
    qdtype, k_scales, v_scales = kv_storage(quant_mode, dtype, num_layers, num_kv_heads,
                                            calibration_scale, dev)
    return KVCache(
        k=torch.zeros(shape, dtype=qdtype, device=dev),
        v=torch.zeros(shape, dtype=qdtype, device=dev),
        lengths=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        k_scales=k_scales,
        v_scales=v_scales,
    )


def quantize_new(x: torch.Tensor, scales: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """New K/V rows (B, Hkv, ...) in the cache's dtype: quantized against
    the fixed per-head ``scales`` when there are any (JAX ``_quantize_new``)."""
    if scales is None:
        return x.to(dtype)
    return quant.quantize_value(x, scales, "int8" if dtype == torch.int8 else "fp8", head_axis=1)


def dequantize_rows(table: torch.Tensor, scales: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """(B, Hkv, S, D) rows of one layer in ``dtype``: ``values * scale[h]`` in
    fp32, then one cast (the JAX prefill's dequant); unquantized rows are
    only cast."""
    if scales is None:
        return table.to(dtype)
    return (table.float() * scales.float()[None, :, None, None]).to(dtype)


def append_decode(cache: KVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor) -> KVCache:
    """Write one token's K/V rows (B, Hkv, D) at each sequence's
    ``lengths[b]`` slot of ``layer``, IN PLACE, through the
    ``append_rows_kv`` kernel. Positions clamp to the last slot, as the JAX
    package's ``dynamic_update_slice`` does. ``lengths`` is not advanced:
    call :func:`advance` once after all layers. A quantized cache gets the
    rows quantized against its scales first."""
    ks, vs = cache.layer_scales(layer)
    pos = torch.clamp(cache.lengths, max=cache.max_seq_len - 1)
    append_rows_kv(cache.k, cache.v, quantize_new(k_new, ks, cache.k.dtype),
                   quantize_new(v_new, vs, cache.v.dtype), layer, pos)
    return cache


def append_decode_attend(cache: KVCache, layer: int, q: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, lengths: torch.Tensor, *, sm_scale=None,
                         num_splits: int = 4, block_k: int = 256, **opts) -> torch.Tensor:
    """:func:`append_decode` and the decode attention over ``lengths`` in
    one launch (``ops.flash_decode.flash_decode_append``, the decode
    kernel with K3 folded in): one token's K/V rows (B, Hkv, D) go to each
    sequence's ``lengths[b]`` slot of ``layer`` (clamped to the last slot),
    IN PLACE, quantized against the cache's scales first, and q (B, Hq, D)
    attends the first ``lengths`` rows (the new one included) -> (B, Hq, D).
    ``opts``: the attention variants (``window``, ``sinks``, ``softcap``).
    ``cache.lengths`` is not advanced."""
    ks, vs = cache.layer_scales(layer)
    return flash_decode_append(q, cache.k, cache.v, quantize_new(k_new, ks, cache.k.dtype).contiguous(),
                               quantize_new(v_new, vs, cache.v.dtype).contiguous(), cache.lengths,
                               lengths, layer=layer, sm_scale=sm_scale, num_splits=num_splits,
                               block_k=block_k, k_scales=ks, v_scales=vs, **opts)


def check_prefill_window(cache: KVCache, sq: int, rows: torch.Tensor | None = None) -> None:
    """Raise when an Sq-row prompt window at ``lengths`` would run past the
    cache: the JAX package's ``dynamic_update_slice`` would shift it left
    over valid rows instead. ``rows`` (a long tensor of row indices)
    restricts the check to the rows being written; None checks every row."""
    lengths = cache.lengths if rows is None else cache.lengths[rows]
    if lengths.numel() == 0:
        return
    top = int(lengths.max())
    if top + sq > cache.max_seq_len:
        raise ValueError(
            f"prefill window of {sq} rows at lengths up to {top} "
            f"overruns the cache ({cache.max_seq_len} rows)")


def append_prefill(cache: KVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
                   rows: torch.Tensor | None = None, check: bool = True) -> KVCache:
    """Write a prompt chunk (B, Hkv, Sq, D) at rows ``[lengths[b],
    lengths[b] + Sq)`` of ``layer``, IN PLACE. ``rows`` (a long tensor of
    row indices) writes only those sequences: every other row's cache stays
    byte for byte as it was (the serving engine's busy slots). Raises when a
    written window would run past the cache (:func:`check_prefill_window`);
    ``check=False`` skips that check (and its host sync) for a caller that
    made it once for all layers. A quantized cache gets the rows quantized
    against its scales first."""
    b, _, sq, _ = k_new.shape
    if check:
        check_prefill_window(cache, sq, rows)
    if rows is None:
        rows = torch.arange(b, device=cache.k.device)
    pos = cache.lengths.long()[rows][:, None] + torch.arange(sq, device=cache.k.device)[None, :]
    # advanced indices (R, 1) x (R, Sq) around the head slice address an
    # (R, Sq, Hkv, D) block
    ks, vs = cache.layer_scales(layer)
    for table, new, scales in ((cache.k, k_new, ks), (cache.v, v_new, vs)):
        table[layer][rows[:, None], :, pos] = quantize_new(new[rows], scales, table.dtype).transpose(1, 2)
    return cache


def advance(cache: KVCache, steps: torch.Tensor | int = 1) -> KVCache:
    """Advance ``lengths`` in place after a full model step (all layers
    appended); returns the same cache for call-site parity with JAX."""
    cache.lengths += steps
    return cache
