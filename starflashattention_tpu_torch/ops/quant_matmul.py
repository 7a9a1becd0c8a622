"""Quantized matmuls — twin of the JAX ``ops/quant_matmul.py``.

- ``quant_matmul(x, w, scale, layer=, out_dtype=)``: int8 / fp8 weight-only,
  ``x @ (w[layer] * scale[layer])`` with fp32 accumulation. On CUDA tensors
  it launches ``csrc/quant_matmul.cu`` (replaces the TPU kernel
  ``_qmm_kernel``): the layer is a pointer offset into the (L, H, O) stack
  and the 8-bit weights are converted in registers, never into a
  dequantized copy. Up to 64 rows (decode steps, verify spans, MoE experts)
  the split-K form runs: bands of 128 output columns times K ranges, the
  grid from :func:`small_m_grid` (shapes and SM count only), the weights
  streamed through a ``cp.async`` ring into the mma's A slot
  (:func:`small_m_fragment` gives the (k, column) each register holds), and
  the splits' fp32 partials summed in split order by each band's last block
  on a workspace cached per device and stream; the column scale is applied
  once to the full sum. Past 64 rows the tiled form (128 x 256 tiles on a
  ``cp.async`` ring) reads the weights as 32-bit words of 4 columns;
  :func:`k4_b_fragment` gives the (k, column) each register holds.
- ``quant_matmul_int4``: nibble-packed int4 weights with grouped scales
  (``core/quant.quantize_weight_int4``); the int4 mode of the same source
  (replaces ``_qmm_int4_kernel``), with the same two forms: the split-K
  splits hold whole groups. Both nibbles of a byte are unpacked in
  registers, and each group's fp32 partial product is multiplied by its
  scale before it joins the accumulator.
- ``quant_matmul_w8a8`` / ``quant_matmul_w4a8``: the activations are
  quantized per row (:func:`quantize_rows`, plain torch, as XLA computed it
  outside any kernel), then int8 x int8 products accumulate in int32 on the
  tensor cores' int8 path: ``csrc/quant_matmul_a8.cu`` (replaces
  ``_qmm_w8a8_kernel`` and ``_qmm_w4a8_kernel``). Both kernels read the
  weight rows as 32-bit words and transpose 4 x 4 blocks of bytes in
  registers; :func:`k10_b_fragment` and :func:`k11_b_fragment` give the
  (k, column) each register byte holds, :func:`w8a8_grid` W8A8's tiles.

On CPU tensors every entry runs its ``*_plain`` twin. Each launch counts
once in the entry's ``launches``; ``launches_tiled`` counts the launches of
the weight-only entries that took the tiled (more than 64 rows) kernel.

Under tensor parallelism the row-parallel projections (``wo``, ``w_down``)
see a shard of each activation row: ``axis`` (a ``parallel.mesh.Axis``,
JAX's ``axis_name``) max-reduces each row's absmax over the axis before
the scale is taken, so every shard quantizes with the full row's scale,
the single process's bit for bit (a max is exact). The kernels do not
change.
"""

from __future__ import annotations

import ctypes

import torch

from starflashattention_tpu_torch.core.quant import unpack_int4
from starflashattention_tpu_torch.ops import _build
from starflashattention_tpu_torch.utils.device import sm_count

_SIGNATURES = {
    "quant_matmul": [_build.P] * 6 + [_build.I] * 6 + [_build.P],
    "quant_matmul_int4": [_build.P] * 6 + [_build.I] * 6 + [_build.P],
}
_A8_SIGNATURES = {"quant_matmul_a8": [_build.P] * 5 + [_build.I] * 5 + [_build.P],
                  "quant_matmul_w8a8_geometry": [_build.P]}
_WEIGHT_DTYPES = (torch.int8, torch.float8_e4m3fn)
SMALL_M_MAX = 64  # rows up to which csrc/quant_matmul.cu runs its split-K form
SMALL_M_BAND = 128  # output columns a split-K block (the kernel's SK_BN)
SMALL_M_BLOCKS_PER_SM = 3  # the grid's aim: one wave of this many blocks an SM
W8A8_TILE = (128, 256, 128)  # W8A8's output rows and columns a block, K columns a ring stage


def _stack(w, scale, layer):
    if w.dim() == 2:
        return w[None], scale[None], 0
    if layer is None:
        raise ValueError("layer index required for stacked (L, H, O) weights")
    return w, scale, int(layer)


def _int_dot(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 matrices (float64 holds every int32 sum)."""
    return torch.matmul(a8.double(), b8.double())


def _int4_groups(w, scale, layer):
    """(x column slices, lo, hi nibble matrices, scale row) per group of one layer."""
    packed, s = w[layer], scale[layer]
    g = s.shape[0]
    hp, o = packed.shape
    half = hp // g
    lo, hi = unpack_int4(packed.reshape(g, half, o))
    for gi in range(g):
        c0 = 2 * half * gi
        yield slice(c0, c0 + half), slice(c0 + half, c0 + 2 * half), lo[gi], hi[gi], s[gi]


# ----------------------------------------------------------------- plain versions


def quant_matmul_plain(x, w, scale, *, layer=None, out_dtype=None):
    """Plain PyTorch version: upcast the layer's weights, fp32 matmul, scale."""
    w, scale, layer = _stack(w, scale, layer)
    y = torch.matmul(x.float(), w[layer].float()) * scale[layer].float()
    return y.to(out_dtype or torch.float32)


def quant_matmul_int4_plain(x, w, scale, *, layer=None, out_dtype=None):
    """Plain int4 version: per group, the two nibble halves against their
    activation slices in fp32, times the group's scale, summed over groups."""
    w, scale, layer = _stack(w, scale, layer)
    xf = x.float()
    acc = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32, device=x.device)
    for lo_cols, hi_cols, lo, hi, s in _int4_groups(w, scale, layer):
        acc += (xf[:, lo_cols] @ lo.float() + xf[:, hi_cols] @ hi.float()) * s
    return acc.to(out_dtype or torch.float32)


def quantize_rows(x: torch.Tensor, eps: float = 1e-6, axis=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of activations -> (x int8 (M, H),
    row scale (M, 1) fp32). Same bytes as the JAX package's eager
    ``quantize_rows``. With ``axis`` (``x`` a shard of each row) the row
    absmax is max-reduced over the axis first (JAX's ``pmax``)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    if axis is not None:
        from starflashattention_tpu_torch.parallel.comm import all_reduce

        absmax = all_reduce(absmax, axis, op="max")
    rs = torch.clamp(absmax, min=eps) / 127.0
    return torch.round(xf / rs).clamp(-127, 127).to(torch.int8), rs


def quant_matmul_w8a8_plain(x, w, scale, *, layer=None, out_dtype=None, axis=None):
    """Plain W8A8: exact int8 x int8 sums, then ``f32(acc) * rs * s``."""
    w, scale, layer = _stack(w, scale, layer)
    x8, rs = quantize_rows(x, axis=axis)
    y = _int_dot(x8, w[layer]).float() * rs * scale[layer].float()
    return y.to(out_dtype or torch.float32)


def quant_matmul_w4a8_plain(x, w, scale, *, layer=None, out_dtype=None, axis=None):
    """Plain W4A8: exact int8 x int4 sums per group, each times its group
    scale in fp32, summed over groups, times the row scale at the end."""
    w, scale, layer = _stack(w, scale, layer)
    x8, rs = quantize_rows(x, axis=axis)
    acc = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32, device=x.device)
    for lo_cols, hi_cols, lo, hi, s in _int4_groups(w, scale, layer):
        acc += (_int_dot(x8[:, lo_cols], lo) + _int_dot(x8[:, hi_cols], hi)).float() * s
    return (acc * rs).to(out_dtype or torch.float32)


# ----------------------------------------------------------------- fragment maps


def k4_b_fragment(lane: int) -> dict:
    """K4's tiled kernel (``qmm_8bit_tiled``): what lane ``lane`` holds in
    one k16 step of one 32-column band of a warp. Returns ``{"b": {(tile i,
    register r, half e): (k, column)}, "store": {(tile i, accumulator j):
    (row, column)}}``, k within the step (0-15), columns within the band
    (0-31), rows within the m16 tile.

    The lane (g, t) reads 32-bit words at rows 2t, 2t + 1, 2t + 8, 2t + 9,
    columns 4g .. 4g + 3; byte i feeds n8 tile i, whose mma sees it at
    column g and k 2t + 8r + e (the m16n8k16 B layout). The mma puts
    accumulator j of tile i at row g + 8 (j // 2), column 2t + j % 2 of the
    tile, which is band column 4 (2t + j % 2) + i: the lane stores the 8
    consecutive columns 8t .. 8t + 7."""
    g, t = lane >> 2, lane & 3
    b = {(i, r, e): (2 * t + 8 * r + e, 4 * g + i) for i in range(4) for r in range(2) for e in range(2)}
    store = {(i, j): (g + 8 * (j // 2), 4 * (2 * t + j % 2) + i) for i in range(4) for j in range(4)}
    return {"b": b, "store": store}


def k10_b_fragment(lane: int) -> dict:
    """K10's W8A8 kernel (``qmm_w8a8_tiled``): what lane ``lane`` holds in
    one k32 step of one 32-column band of a warp. Returns ``{"b": {(tile i,
    register r, byte q): (k, column)}, "store": {(tile i, accumulator j):
    (row, column)}}``, k within the step (0-31), columns within the band.

    The lane (g, t) reads the words of weight rows 16r + 4t + q (q = 0..3),
    columns 4g .. 4g + 3, and transposes each 4 x 4 byte block: register r
    of tile i holds column 4g + i of the four rows, row q in byte q, which
    the m16n8k32 mma sees at column g and k 16r + 4t + q. The store is
    K4's: accumulator j of tile i at column 4 (2t + j % 2) + i."""
    g, t = lane >> 2, lane & 3
    b = {(i, r, q): (16 * r + 4 * t + q, 4 * g + i) for i in range(4) for r in range(2) for q in range(4)}
    return {"b": b, "store": k4_b_fragment(lane)["store"]}


def k11_b_fragment(lane: int) -> dict:
    """K11's W4A8 kernel (``qmm_w4a8_tiled``): what lane ``lane`` holds in
    one chunk (32 packed rows) of a warp's 32 columns, in K10's layout
    (:func:`k10_b_fragment`) with packed rows for k: ``{"b": {(tile i,
    register r, byte q): (packed row, column)}, "store": ...}``. The low
    nibble of the byte is contraction row ``packed row`` of the chunk's low
    half, the high nibble the same row of its high half."""
    return k10_b_fragment(lane)


def w8a8_grid(m: int, k: int, n: int) -> tuple[int, int, int]:
    """(row tiles, column tiles, ring stages) of K10 for x8 (m, k) @ w (k,
    n): W8A8_TILE's 128 x 256 tiles, the last row and column tiles partial
    (rows past m and columns past n zero-filled), stages of 128 K columns,
    the last one half when k % 128 == 64. Raises for a geometry the kernel
    does not take (k % 64, n % 32)."""
    bm, bn, sk = W8A8_TILE
    if k % 64 or n % 32:
        raise ValueError(f"the CUDA kernel needs H a multiple of 64 and O of 32, got H={k}, O={n}")
    return -(-m // bm), -(-n // bn), -(-k // sk)


# ----------------------------------------------------------------- the split-K grid (M <= 64)


def small_m_rows(m: int) -> int:
    """The x rows a split-K block stages for ``m`` rows (8, 16, 32 or 64: its
    n8 tiles times 8); its fp32 partial is that many rows of SMALL_M_BAND."""
    return next(r for r in (8, 16, 32, 64) if m <= r)


def small_m_grid(m: int, k: int, n: int, group: int | None = None, sms: int = 132,
                 splits: int | None = None) -> tuple[int, int, int]:
    """The split-K form's grid for ``m`` rows of x (m, k) @ w (k, n):
    ``(bands, splits, split)``, ``bands`` of SMALL_M_BAND output columns (the
    last may be partial) times ``splits`` K ranges of ``split`` rows (the last
    may be shorter). ``split`` is a multiple of 16 rows (one k16 step) or,
    for int4 (``group``), of the group: a split holds whole groups.

    By default the most splits whose blocks fit SMALL_M_BLOCKS_PER_SM *
    ``sms`` (one wave of three blocks an SM), none shorter than 4 weight
    rows (int4: packed rows) per x row the block stages, so that a split's
    fp32 partial is never larger than its weights. ``splits`` asks for about
    that many instead (whole units). Depends on the shapes and the SM count
    only, never on the data."""
    bands = -(-n // SMALL_M_BAND)
    unit = group or 16
    steps = k // unit
    if splits is None:
        shortest = -(-4 * small_m_rows(m) // (unit // 2 if group else unit))
        fit = max(1, SMALL_M_BLOCKS_PER_SM * sms // bands)
        per = min(steps, max(shortest, -(-steps // fit)))
    else:
        per = -(-steps // max(1, min(splits, steps)))
    return bands, -(-steps // per), per * unit


def small_m_fragment(lane: int) -> dict:
    """The split-K form (``qmm_split_k``): what lane ``lane`` holds in one
    k16 step (int4: one chunk of 16 packed rows) of its warp's 16 columns.
    Returns ``{"a": {(register r, half h): (k, column)}, "b": {(register r,
    half h): (k, x row)}, "acc": {accumulator i: (x row, column)}}``: k
    within the step (int4: the chunk's packed row, whose low nibble meets
    the group's low x columns and whose high nibble those half a group on),
    columns within the warp's 16, x rows within an n8 tile.

    The weights are the m16n8k16 product's A. Lane (g, t) reads 32-bit
    words at rows 2t, 2t + 1, 2t + 8, 2t + 9 of columns 4 (g // 2) .. + 3,
    shifted right by 8 (g % 2) bits; bytes 0 and 2 of them are A's rows g
    and g + 8, the columns 4 (g // 2) + g % 2 and that + 2. The mma sees
    half h of A register r at row g + 8 (r % 2), k 2t + 8 (r // 2) + h; of
    B register r (x, by ldmatrix) at k 2t + 8 r + h, column (x row) g; and
    accumulator i at C's row g + 8 (i // 2), column 2t + i % 2."""
    g, t = lane >> 2, lane & 3
    col = 4 * (g >> 1) + (g & 1)
    return {"a": {(r, h): (2 * t + 8 * (r >> 1) + h, col + 2 * (r & 1)) for r in range(4) for h in range(2)},
            "b": {(r, h): (2 * t + 8 * r + h, g) for r in range(2) for h in range(2)},
            "acc": {i: (2 * t + (i & 1), col + 2 * (i >> 1)) for i in range(4)}}


_SMALL_M_WORKSPACE: dict[tuple[int, int], dict] = {}


def _small_m_workspace(device, floats, bands):
    """fp32 partials (at least ``floats``) and ``bands`` int32 arrival
    counters (zeros; the kernel leaves them at zero) for a split-K launch,
    cached per device and stream and grown when a call needs more. The
    launches on one stream run in order, so one workspace serves them all."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ws = _SMALL_M_WORKSPACE.get(key)
    if ws is None or ws["part"].numel() < floats or ws["arrivals"].numel() < bands:
        old_part, old_bands = (0, 0) if ws is None else (ws["part"].numel(), ws["arrivals"].numel())
        ws = {"part": torch.empty(max(floats, old_part), dtype=torch.float32, device=device),
              "arrivals": torch.zeros(max(bands, old_bands), dtype=torch.int32, device=device)}
        _SMALL_M_WORKSPACE[key] = ws
    return ws["part"], ws["arrivals"]


# ----------------------------------------------------------------- kernels


def _prepare(name, x, w, scale, layer, out_dtype, x_dtype=torch.bfloat16):
    """Shared wrapper checks -> (x, stacked w, scale, layer, out_dtype)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    w, scale, layer = _stack(w, scale, layer)
    out_dtype = out_dtype or torch.float32
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (M, H), got {tuple(x.shape)}")
    if x.dtype != x_dtype:
        raise ValueError(f"{name}: the CUDA kernel takes {x_dtype} activations, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: unsupported out_dtype {out_dtype}")
    if not (w.is_contiguous() and scale.is_contiguous()) or scale.dtype != torch.float32:
        raise ValueError(f"{name}: weights and fp32 scales must be contiguous")
    if not 0 <= layer < w.shape[0]:
        raise ValueError(f"{name}: layer {layer} out of range for {w.shape[0]} layers")
    if w.data_ptr() % 16:
        raise ValueError(f"{name}: weights must be 16-byte aligned")
    x = x.contiguous()
    if x.data_ptr() % 16:  # a view at an odd offset: the kernels load 16 bytes at a time
        x = x.clone()
    return x, w, scale, layer, out_dtype


def _layer_ptrs(w, scale, layer):
    """This layer's slices of the (L, ...) weight and scale stacks."""
    per_w, per_s = w[0].numel() * w.element_size(), scale[0].numel() * 4
    return _build.P(w.data_ptr() + layer * per_w), _build.P(scale.data_ptr() + layer * per_s)


def _launch(entry, x, w, scale, layer, out_dtype, half=0, splits=None):
    """``csrc/quant_matmul.cu`` on inputs the entry checked (``w`` /
    ``scale`` stacked): ``half`` 0 for 8-bit weights, else the packed rows
    of an int4 half group. Up to SMALL_M_MAX rows the split-K form on
    :func:`small_m_grid`'s grid (``splits``: about that many K splits
    instead, as ``chip_smoke.py`` times other grids), else the tiled form.
    Counts the launch in ``entry.launches`` (and ``launches_tiled``)."""
    (m, k), n = x.shape, w.shape[-1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    part = arrivals = None
    split = 0
    if m <= SMALL_M_MAX:
        bands, n_splits, split = small_m_grid(m, k, n, 2 * half or None, sm_count(x.device), splits)
        if n_splits > 1:
            part, arrivals = _small_m_workspace(x.device, bands * n_splits * small_m_rows(m) * SMALL_M_BAND,
                                                bands)
    args = (_build.ptr(x), *_layer_ptrs(w, scale, layer), _build.ptr(out),
            None if part is None else _build.ptr(part), None if arrivals is None else _build.ptr(arrivals),
            m, k, n)
    out_bf16 = int(out_dtype == torch.bfloat16)
    lib = _build.load("quant_matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        if half:
            err = lib.quant_matmul_int4(*args, half, split, out_bf16, _build.stream_ptr(x.device))
        else:
            err = lib.quant_matmul(*args, split, int(w.dtype == torch.float8_e4m3fn), out_bf16,
                                   _build.stream_ptr(x.device))
    _build.check(lib, err, entry.__name__)
    entry.launches += 1
    if m > SMALL_M_MAX:
        entry.launches_tiled += 1
    return out


def quant_matmul(    x: torch.Tensor,  # (M, H) activations
    w: torch.Tensor,  # (H, O) or (L, H, O) int8 / float8_e4m3fn
    scale: torch.Tensor,  # (O,) or (L, O) fp32 per-output-channel scales
    *,
    layer: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ dequant(w[layer])`` -> (M, O) in ``out_dtype`` (default fp32)."""
    if w.dtype not in _WEIGHT_DTYPES:
        raise ValueError(f"quant_matmul takes int8/fp8 weights, got {w.dtype}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w, scale, layer=layer, out_dtype=out_dtype)
    x, w, scale, layer, out_dtype = _prepare("quant_matmul", x, w, scale, layer, out_dtype)
    n_layers, h, o = w.shape
    if x.shape[1] != h:
        raise ValueError(f"x {tuple(x.shape)} does not match weights {tuple(w.shape)}")
    if h % 32 or o % 32:
        raise ValueError(f"the CUDA kernel needs H and O multiples of 32, got H={h}, O={o}")
    if scale.shape != (n_layers, o):
        raise ValueError(f"scale {tuple(scale.shape)} does not match weights {tuple(w.shape)}")
    return _launch(quant_matmul, x, w, scale, layer, out_dtype)


quant_matmul.launches = 0  # every launch
quant_matmul.launches_tiled = 0  # those that took the tiled (prefill-row) form


def _int4_geometry(name, x, w, scale, multiple):
    """(M, H, O, half) of an int4 call; raises for a geometry the kernels do
    not take (``multiple`` is the packed rows one kernel step consumes)."""
    n_layers, hp, o = w.shape
    g = scale.shape[1]
    if w.dtype != torch.int8 or scale.shape != (n_layers, g, o) or hp % g:
        raise ValueError(f"{name}: packed int8 weights (L, H/2, O) with (L, G, O) scales expected, "
                         f"got {tuple(w.shape)} {w.dtype} / {tuple(scale.shape)}")
    half = hp // g
    if x.shape[1] != 2 * hp:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match packed weights {tuple(w.shape)}")
    if half % multiple or o % 32:
        raise ValueError(f"{name}: the CUDA kernel needs group/2 a multiple of {multiple} and O a "
                         f"multiple of 32, got group {2 * half}, O={o}")
    return x.shape[0], 2 * hp, o, half


def quant_matmul_int4(
    x: torch.Tensor,  # (M, H) activations
    w: torch.Tensor,  # (H/2, O) or (L, H/2, O) int8, packed nibble pairs
    scale: torch.Tensor,  # (G, O) or (L, G, O) fp32 per-(group, output-channel) scales
    *,
    layer: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ dequant_int4(w[layer])`` -> (M, O) in ``out_dtype`` (default
    fp32): kernel K6, split-K (<= 64 rows) or tiled."""
    if x.device.type == "cpu":
        return quant_matmul_int4_plain(x, w, scale, layer=layer, out_dtype=out_dtype)
    x, w, scale, layer, out_dtype = _prepare("quant_matmul_int4", x, w, scale, layer, out_dtype)
    half = _int4_geometry("quant_matmul_int4", x, w, scale, 16)[3]
    return _launch(quant_matmul_int4, x, w, scale, layer, out_dtype, half)


quant_matmul_int4.launches = 0
quant_matmul_int4.launches_tiled = 0


def _launch_a8(entry, x8, rs, w, scale, layer, out_dtype, half):
    """csrc/quant_matmul_a8.cu on rows quantized by :func:`quantize_rows`
    (``x8`` (M, H) int8, ``rs`` (M, 1) fp32, on the card; ``w`` / ``scale``
    stacked and checked by the entry): ``half`` 0 for int8 weights (W8A8),
    else the packed rows per int4 half group (W4A8). Counts the launch in
    ``entry.launches``. ``chip_smoke.py`` times the kernel alone through it."""
    m, o = x8.shape[0], w.shape[-1]
    out = torch.empty((m, o), dtype=out_dtype, device=x8.device)
    if m == 0:
        return out
    lib = _build.load("quant_matmul_a8", _A8_SIGNATURES)
    with torch.cuda.device(x8.device):
        err = lib.quant_matmul_a8(
            _build.ptr(x8), _build.ptr(rs.contiguous()), *_layer_ptrs(w, scale, layer),
            _build.ptr(out), m, x8.shape[1], o, half, int(out_dtype == torch.bfloat16),
            _build.stream_ptr(x8.device),
        )
    _build.check(lib, err, entry.__name__)
    entry.launches += 1
    return out


def quant_matmul_w8a8(
    x: torch.Tensor,  # (M, H) activations, quantized per row here
    w: torch.Tensor,  # (H, O) or (L, H, O) int8
    scale: torch.Tensor,  # (O,) or (L, O) fp32
    *,
    layer: int | None = None,
    out_dtype: torch.dtype | None = None,
    axis=None,
) -> torch.Tensor:
    """W8A8: per-row int8 activations x int8 weights, int32 sums,
    ``f32(acc) * rs[row] * s[col]`` -> (M, O) (kernel K10). ``axis``: see
    :func:`quantize_rows` (the row-parallel projections under TP)."""
    if w.dtype != torch.int8:
        raise ValueError(f"W8A8 requires int8 weights, got {w.dtype}")
    if x.device.type == "cpu":
        return quant_matmul_w8a8_plain(x, w, scale, layer=layer, out_dtype=out_dtype, axis=axis)
    x, w, scale, layer, out_dtype = _prepare("quant_matmul_w8a8", x, w, scale, layer, out_dtype)
    n_layers, h, o = w.shape
    if x.shape[1] != h or scale.shape != (n_layers, o):
        raise ValueError(f"x {tuple(x.shape)} / scale {tuple(scale.shape)} do not match weights "
                         f"{tuple(w.shape)}")
    w8a8_grid(x.shape[0], h, o)
    return _launch_a8(quant_matmul_w8a8, *quantize_rows(x, axis=axis), w, scale, layer, out_dtype, 0)


quant_matmul_w8a8.launches = 0


def w8a8_built_geometry() -> tuple[int, int, int, int]:
    """K10's (rows, columns, K columns a stage, dynamic shared memory bytes)
    as the built library reports them (loads it)."""
    lib = _build.load("quant_matmul_a8", _A8_SIGNATURES)
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.quant_matmul_w8a8_geometry(out), "quant_matmul_w8a8_geometry")
    return tuple(out)


def quant_matmul_w4a8(
    x: torch.Tensor,  # (M, H) activations, quantized per row here
    w: torch.Tensor,  # (H/2, O) or (L, H/2, O) int8, packed nibble pairs
    scale: torch.Tensor,  # (G, O) or (L, G, O) fp32 grouped scales
    *,
    layer: int | None = None,
    out_dtype: torch.dtype | None = None,
    axis=None,
) -> torch.Tensor:
    """W4A8: per-row int8 activations x int4 weights unpacked to int8, int32
    sums per group, each times its group scale in fp32, times the row scale
    at the store -> (M, O) (kernel K11). ``axis`` as for W8A8."""
    if x.device.type == "cpu":
        return quant_matmul_w4a8_plain(x, w, scale, layer=layer, out_dtype=out_dtype, axis=axis)
    x, w, scale, layer, out_dtype = _prepare("quant_matmul_w4a8", x, w, scale, layer, out_dtype)
    _, _, _, half = _int4_geometry("quant_matmul_w4a8", x, w, scale, 32)
    return _launch_a8(quant_matmul_w4a8, *quantize_rows(x, axis=axis), w, scale, layer, out_dtype, half)


quant_matmul_w4a8.launches = 0
