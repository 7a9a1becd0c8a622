"""In-place KV-cache row append — twin of the JAX ``ops/cache_append.py``.

``append_rows_kv`` writes ``table[layer, b, :, pos[b], :] = new[b]`` for the
K and the V table in place; ``append_rows`` does the same for one table.
On CUDA tensors both launch ``csrc/cache_append.cu`` (which replaces the TPU
kernels ``_append_kernel_kv`` and ``_append_kernel_one``); on CPU tensors
they run :func:`append_rows_kv_plain`.
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.ops import _build

_SIGNATURES = {
    "append_rows": [_build.P, _build.P, _build.P, _build.P, _build.P,
                    _build.I, _build.I, _build.I, _build.I, _build.I,
                    _build.I, _build.P],
}


def append_rows_kv_plain(k_table, v_table, k_new, v_new, layer, pos):
    """Plain PyTorch version: advanced-index assignment into the layer view."""
    bidx = torch.arange(k_new.shape[0], device=k_table.device)
    pos = pos.to(device=k_table.device, dtype=torch.long)
    for table, new in ((k_table, k_new), (v_table, v_new)):
        if table is None:
            continue
        layer_view = table[int(layer)]  # (B, Hkv, S, D), shares storage
        layer_view[bidx, :, pos] = new.to(table.dtype)
    return k_table, v_table


def _check(table, new, pos, layer):
    l, b, hkv, s, d = table.shape
    if new.shape != (b, hkv, d):
        raise ValueError(f"new rows {tuple(new.shape)} do not match table {tuple(table.shape)}")
    if new.dtype != table.dtype:
        raise ValueError(f"new rows are {new.dtype}, table is {table.dtype}")
    if not table.is_contiguous():
        raise ValueError("cache table must be contiguous")
    if pos.shape != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    if not 0 <= int(layer) < l:
        raise ValueError(f"layer {layer} out of range for {l} layers")


def _launch(k_table, v_table, k_new, v_new, layer, pos):
    if k_table.device.type != "cuda":
        raise ValueError(f"append_rows: unsupported device {k_table.device}")
    _check(k_table, k_new, pos, layer)
    if v_table is not None:
        if v_table.shape != k_table.shape:
            raise ValueError("K and V tables differ in shape")
        _check(v_table, v_new, pos, layer)
        v_new = v_new.contiguous()
    k_new = k_new.contiguous()
    pos = pos.to(device=k_table.device, dtype=torch.int32).contiguous()
    _, b, hkv, s, d = k_table.shape
    row_bytes = d * k_table.element_size()
    tensors = [t for t in (k_table, v_table, k_new, v_new) if t is not None]
    vec16 = int(row_bytes % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))
    lib = _build.load("cache_append", _SIGNATURES)
    with torch.cuda.device(k_table.device):
        err = lib.append_rows(
            _build.ptr(k_table), _build.ptr(v_table) if v_table is not None else None,
            _build.ptr(k_new), _build.ptr(v_new) if v_new is not None else None,
            _build.ptr(pos), int(layer), b, hkv, s, row_bytes, vec16,
            _build.stream_ptr(k_table.device),
        )
    _build.check(lib, err, "append_rows")


def append_rows_kv(
    k_table: torch.Tensor,  # (L, B, Hkv, S, D)
    v_table: torch.Tensor,
    k_new: torch.Tensor,  # (B, Hkv, D), same dtype as the tables
    v_new: torch.Tensor,
    layer: int,
    pos: torch.Tensor,  # (B,) int32 — the caller clamps it below S
) -> tuple[torch.Tensor, torch.Tensor]:
    """``table[layer, b, :, pos[b], :] = new[b]`` for both tables, IN PLACE.
    Returns the (same) tables for call-site parity with the JAX op."""
    if k_table.device.type == "cpu":
        return append_rows_kv_plain(k_table, v_table, k_new, v_new, layer, pos)
    _launch(k_table, v_table, k_new, v_new, layer, pos)
    append_rows_kv.launches += 1
    return k_table, v_table


append_rows_kv.launches = 0


def append_rows(table, new, layer, pos):
    """One-table form of :func:`append_rows_kv` (in place)."""
    if table.device.type == "cpu":
        append_rows_kv_plain(table, None, new, None, layer, pos)
        return table
    _launch(table, None, new, None, layer, pos)
    append_rows.launches += 1
    return table


append_rows.launches = 0
