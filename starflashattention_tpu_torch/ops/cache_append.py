"""In-place KV-cache row append — twin of the JAX ``ops/cache_append.py``.

``append_rows_kv`` writes ``table[layer, b, :, pos[b], :] = new[b]`` for the
K and the V table in place; ``append_rows`` does the same for one table;
``append_rows_paged_kv`` writes ``pool[layer, :, page_table[b, pos[b] // ps],
pos[b] % ps, :] = new[b]`` into the K and V page pools; ``append_block_kv``
writes the first ``n_valid[b]`` of T rows ``table[layer, b, :, pos[b] + j,
:] = new[b, :, j]`` (speculative decoding's verify step). On CUDA tensors
all four launch ``csrc/cache_append.cu`` (which replaces the TPU kernels
``_append_kernel_kv``, ``_append_kernel_one``, ``_append_kernel_paged`` and
``_append_block_kernel_kv``); on CPU tensors they run the plain versions
below. The model's decode and verify steps launch none of them: their
appends are folded into the attention's launch
(``ops/flash_decode.flash_decode_append`` and ``flash_verify_append``,
``ops/paged_decode.paged_flash_decode_append``), whose plain twins are
these plain versions followed by the attention's. They stay as the ports
of JAX's public entries.
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.ops import _build

_SIGNATURES = {
    "append_rows": [_build.P, _build.P, _build.P, _build.P, _build.P,
                    _build.I, _build.I, _build.I, _build.I, _build.I,
                    _build.I, _build.P],
    "append_rows_paged": [_build.P] * 6 + [_build.I] * 8 + [_build.P],
    "append_block": [_build.P] * 6 + [_build.I] * 7 + [_build.P],
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


# ----------------------------------------------------------------- paged pools


def append_rows_paged_kv_plain(k_pages, v_pages, k_new, v_new, layer, page_table, pos):
    """Plain PyTorch version of :func:`append_rows_paged_kv`."""
    ps = k_pages.shape[3]
    pos = pos.to(device=k_pages.device, dtype=torch.long)
    phys = page_table.to(k_pages.device).long()[torch.arange(pos.shape[0], device=pos.device), pos // ps]
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        # (B, Hkv, D) rows -> the (Hkv, B, D) block the page/slot indices address
        pool[int(layer)][:, phys, pos % ps] = new.transpose(0, 1).to(pool.dtype)
    return k_pages, v_pages


def append_rows_paged_kv(
    k_pages: torch.Tensor,  # (L, Hkv, P, page_size, D)
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # (B, Hkv, D), same dtype as the pools
    v_new: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,  # (B, pages_per_seq) int32
    pos: torch.Tensor,  # (B,) int32 logical position; the caller clamps it below pages_per_seq * ps
) -> tuple[torch.Tensor, torch.Tensor]:
    """``pool[layer, :, page_table[b, pos[b] // ps], pos[b] % ps, :] =
    new[b]`` for both pools, IN PLACE (kernel K8). A row whose table entry
    is the null page 0 writes there, harmlessly. Returns the (same) pools."""
    if k_pages.device.type == "cpu":
        return append_rows_paged_kv_plain(k_pages, v_pages, k_new, v_new, layer, page_table, pos)
    if k_pages.device.type != "cuda":
        raise ValueError(f"append_rows_paged_kv: unsupported device {k_pages.device}")
    l, hkv, num_pages, ps, d = k_pages.shape
    b = k_new.shape[0]
    if v_pages.shape != k_pages.shape or not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("K and V pools must be contiguous and of one shape")
    for new, pool in ((k_new, k_pages), (v_new, v_pages)):
        if new.shape != (b, hkv, d) or new.dtype != pool.dtype:
            raise ValueError(f"new rows {tuple(new.shape)} {new.dtype} do not match pool "
                             f"{tuple(pool.shape)} {pool.dtype}")
    if page_table.dim() != 2 or page_table.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / pos {tuple(pos.shape)} "
                         f"do not match {b} rows")
    if not 0 <= int(layer) < l:
        raise ValueError(f"layer {layer} out of range for {l} layers")
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    pos = pos.to(device=k_pages.device, dtype=torch.int32).contiguous()
    table = page_table.to(device=k_pages.device, dtype=torch.int32).contiguous()
    row_bytes = d * k_pages.element_size()
    tensors = (k_pages, v_pages, k_new, v_new)
    vec16 = int(row_bytes % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))
    lib = _build.load("cache_append", _SIGNATURES)
    with torch.cuda.device(k_pages.device):
        err = lib.append_rows_paged(
            _build.ptr(k_pages), _build.ptr(v_pages), _build.ptr(k_new), _build.ptr(v_new),
            _build.ptr(pos), _build.ptr(table), int(layer), b, hkv, num_pages, ps,
            table.shape[1], row_bytes, vec16, _build.stream_ptr(k_pages.device),
        )
    _build.check(lib, err, "append_rows_paged")
    append_rows_paged_kv.launches += 1
    return k_pages, v_pages


append_rows_paged_kv.launches = 0


# ----------------------------------------------------------------- a block of rows


def append_block_kv_plain(k_table, v_table, k_new, v_new, layer, pos, n_valid=None):
    """Plain PyTorch version of :func:`append_block_kv`: one advanced-index
    assignment a table over the rows it writes (found with ``nonzero``, a
    host sync the kernel does not make)."""
    b, _, t, _ = k_new.shape
    s = k_table.shape[3]
    dev = k_table.device
    pos = pos.to(device=dev, dtype=torch.long)
    n_valid = (torch.full((b,), t, device=dev) if n_valid is None
               else n_valid.to(device=dev, dtype=torch.long))
    j = torch.arange(t, device=dev)[None, :]
    rows = pos[:, None] + j  # (B, T) target positions
    bi, ji = ((j < n_valid[:, None]) & (rows >= 0) & (rows < s)).nonzero(as_tuple=True)
    for table, new in ((k_table, k_new), (v_table, v_new)):
        # (N,) x (N,) around the head slice address an (N, Hkv, D) block
        table[int(layer)][bi, :, rows[bi, ji]] = new[bi, :, ji].to(table.dtype)
    return k_table, v_table


def append_block_kv(
    k_table: torch.Tensor,  # (L, B, Hkv, S, D)
    v_table: torch.Tensor,
    k_new: torch.Tensor,  # (B, Hkv, T, D), same dtype as the tables
    v_new: torch.Tensor,
    layer: int,
    pos: torch.Tensor,  # (B,) int32 — first write position
    n_valid: torch.Tensor | None = None,  # (B,) int32 rows to write (None: all T)
) -> tuple[torch.Tensor, torch.Tensor]:
    """``table[layer, b, :, pos[b] + j, :] = new[b, :, j, :]`` for ``j <
    n_valid[b]``, for both tables, IN PLACE (kernel K9); rows at ``pos + j``
    outside the table are skipped. Returns the (same) tables.

    A call with nothing to write launches nothing and counts no launch in
    ``append_block_kv.launches``: B == 0, T == 0, or an all-zero
    ``n_valid`` that lies on the host. A device ``n_valid`` is never read
    back (that would be a host sync a layer), so such a call launches and
    its blocks exit at once."""
    if k_table.device.type == "cpu":
        return append_block_kv_plain(k_table, v_table, k_new, v_new, layer, pos, n_valid)
    if k_table.device.type != "cuda":
        raise ValueError(f"append_block_kv: unsupported device {k_table.device}")
    l, b, hkv, s, d = k_table.shape
    if v_table.shape != k_table.shape or not (k_table.is_contiguous() and v_table.is_contiguous()):
        raise ValueError("K and V tables must be contiguous and of one shape")
    if k_new.dim() != 4 or k_new.shape[:2] != (b, hkv) or k_new.shape[3] != d:
        raise ValueError(f"new rows {tuple(k_new.shape)} do not match table {tuple(k_table.shape)}")
    t = k_new.shape[2]
    for new, table in ((k_new, k_table), (v_new, v_table)):
        if new.shape != (b, hkv, t, d) or new.dtype != table.dtype:
            raise ValueError(f"new rows {tuple(new.shape)} {new.dtype} do not match table "
                             f"{tuple(table.shape)} {table.dtype}")
    if pos.shape != (b,) or (n_valid is not None and n_valid.shape != (b,)):
        raise ValueError(f"pos and n_valid must be ({b},)")
    if not 0 <= int(layer) < l:
        raise ValueError(f"layer {layer} out of range for {l} layers")
    if b == 0 or t == 0 or (n_valid is not None and n_valid.device.type == "cpu"
                            and not bool((n_valid > 0).any())):
        return k_table, v_table
    if n_valid is None:
        n_valid = torch.full((b,), t, dtype=torch.int32, device=k_table.device)
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    pos = pos.to(device=k_table.device, dtype=torch.int32).contiguous()
    n_valid = n_valid.to(device=k_table.device, dtype=torch.int32).contiguous()
    row_bytes = d * k_table.element_size()
    tensors = (k_table, v_table, k_new, v_new)
    vec16 = int(row_bytes % 16 == 0 and all(x.data_ptr() % 16 == 0 for x in tensors))
    lib = _build.load("cache_append", _SIGNATURES)
    with torch.cuda.device(k_table.device):
        err = lib.append_block(
            _build.ptr(k_table), _build.ptr(v_table), _build.ptr(k_new), _build.ptr(v_new),
            _build.ptr(pos), _build.ptr(n_valid), int(layer), b, hkv, s, t, row_bytes, vec16,
            _build.stream_ptr(k_table.device),
        )
    _build.check(lib, err, "append_block")
    append_block_kv.launches += 1
    return k_table, v_table


append_block_kv.launches = 0
