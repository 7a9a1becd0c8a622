"""Contiguous multi-layer KV-cache tables — twin of the JAX ``cache/contiguous.py``.

Layers stack on one leading axis: ``k``/``v`` are (L, B, Hkv, S, D). The
port updates these tensors IN PLACE (the JAX package donates the cache to
its jitted step instead); the ops in ``ops/`` take the whole table plus a
``layer`` index, so no per-layer copy is ever made.
"""

from __future__ import annotations

import dataclasses

import torch

from starflashattention_tpu_torch.core import quant
from starflashattention_tpu_torch.ops.cache_append import append_rows_kv
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
    lengths = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
    if quant_mode == "none":
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            lengths=lengths,
        )
    qdtype = torch.int8 if quant_mode == "int8" else torch.float8_e4m3fn
    qmax = quant.INT8_MAX if quant_mode == "int8" else quant.FP8_MAX
    scales = torch.full((num_layers, num_kv_heads), calibration_scale / qmax,
                        dtype=torch.float32, device=dev)
    return KVCache(
        k=torch.zeros(shape, dtype=qdtype, device=dev),
        v=torch.zeros(shape, dtype=qdtype, device=dev),
        lengths=lengths,
        k_scales=scales,
        v_scales=scales.clone(),
    )


def _check_unquantized(cache: KVCache) -> None:
    if cache.k_scales is not None:
        raise NotImplementedError(
            "quantized KV caches are not ported yet (ROADMAP Queue 2, K1 options)")


def append_decode(cache: KVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor) -> KVCache:
    """Write one token's K/V rows (B, Hkv, D) at each sequence's
    ``lengths[b]`` slot of ``layer``, IN PLACE, through the
    ``append_rows_kv`` kernel. Positions clamp to the last slot, as the JAX
    package's ``dynamic_update_slice`` does. ``lengths`` is not advanced:
    call :func:`advance` once after all layers."""
    _check_unquantized(cache)
    pos = torch.clamp(cache.lengths, max=cache.max_seq_len - 1)
    append_rows_kv(cache.k, cache.v, k_new.to(cache.k.dtype), v_new.to(cache.v.dtype),
                   layer, pos)
    return cache


def check_prefill_window(cache: KVCache, sq: int) -> None:
    """Raise when an Sq-row prompt window at ``lengths`` would run past the
    cache: the JAX package's ``dynamic_update_slice`` would shift it left
    over valid rows instead."""
    top = int(cache.lengths.max())
    if top + sq > cache.max_seq_len:
        raise ValueError(
            f"prefill window of {sq} rows at lengths up to {top} "
            f"overruns the cache ({cache.max_seq_len} rows)")


def append_prefill(cache: KVCache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor) -> KVCache:
    """Write a prompt chunk (B, Hkv, Sq, D) at rows ``[lengths[b],
    lengths[b] + Sq)`` of ``layer``, IN PLACE. Raises when a window would
    run past the cache (:func:`check_prefill_window`)."""
    _check_unquantized(cache)
    b, _, sq, _ = k_new.shape
    check_prefill_window(cache, sq)
    pos = cache.lengths.long()[:, None] + torch.arange(sq, device=cache.k.device)[None, :]
    bidx = torch.arange(b, device=cache.k.device)[:, None]
    # advanced indices (B, 1) x (B, Sq) around the head slice address a
    # (B, Sq, Hkv, D) block
    cache.k[layer][bidx, :, pos] = k_new.transpose(1, 2).to(cache.k.dtype)
    cache.v[layer][bidx, :, pos] = v_new.transpose(1, 2).to(cache.v.dtype)
    return cache


def advance(cache: KVCache, steps: torch.Tensor | int = 1) -> KVCache:
    """Advance ``lengths`` in place after a full model step (all layers
    appended); returns the same cache for call-site parity with JAX."""
    cache.lengths += steps
    return cache
