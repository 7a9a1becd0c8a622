"""Symmetric INT8 / FP8 (e4m3) / INT4 quantization — twin of the JAX
``core/quant.py``.

Weights get per-output-channel scales (``quantize_weight``), or grouped
contraction-axis scales with two 4-bit values per byte
(``quantize_weight_int4``); KV rows are quantized against fixed per-head
cache scales (``quantize_value``).
``torch.round`` rounds half to even exactly like ``jnp.round``, and the
divisions are the same IEEE fp32 operations, so the int8 bytes and scales
come out identical to the JAX package's.
"""

from __future__ import annotations

import torch

from starflashattention_tpu_torch.runtime.params import QuantMode

INT8_MAX = 127.0
FP8_MAX = 448.0  # float8_e4m3fn max normal


def _to_fp8(scaled: torch.Tensor) -> torch.Tensor:
    """Cast to e4m3fn with saturation (the format has no inf)."""
    return scaled.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)


def _scale_shape(x_ndim: int, head_axis: int, scales: torch.Tensor) -> torch.Tensor:
    shape = [1] * x_ndim
    shape[head_axis] = scales.shape[0]
    return scales.reshape(shape)


def quantize_weight(w: torch.Tensor, mode: str = "int8") -> dict:
    """Weight-only quantization with per-output-channel scales: ``w`` is
    (..., H, O), the scales reduce the contraction axis to (..., O), and
    ``dequant = w_q * scale[..., None, :]``. Returns ``{"w", "scale"}``.
    ``mode="int4"`` routes to the nibble-packed grouped scheme
    (:func:`quantize_weight_int4`, (..., G, O) scales)."""
    if mode == "int4":
        return quantize_weight_int4(w)
    if mode not in ("int8", "fp8"):
        raise ValueError("quantize_weight requires int8, fp8 or int4")
    qmax = INT8_MAX if mode == "int8" else FP8_MAX
    wf = w.float()
    absmax = wf.abs().amax(dim=-2)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / qmax)
    scaled = wf / scale[..., None, :]
    if mode == "int8":
        q = torch.round(scaled).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        q = _to_fp8(scaled)
    return {"w": q, "scale": scale}


def dequantize_weight(wq: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if is_int4_weight(wq):
        return dequantize_weight_int4(wq, dtype)
    return (wq["w"].float() * wq["scale"][..., None, :]).to(dtype)


# ---------------------------------------------------------------------------
# INT4 weights: nibble-packed, grouped contraction-axis scales
# ---------------------------------------------------------------------------

INT4_MAX = 7.0  # symmetric +-7; -8 stays unused so dequant is scale-symmetric
INT4_GROUP = 128  # contraction rows per scale group (a cap, see below)


def default_int4_group(h: int, cap: int = INT4_GROUP) -> int:
    """Largest even group <= ``cap`` that divides ``h`` (nibbles pair within
    a group)."""
    g = min(cap, h)
    while h % g or g % 2:
        g -= 1
    return g


def quantize_weight_int4(w: torch.Tensor, group: int | None = None) -> dict:
    """4-bit weight-only quantization, two values per int8 byte, with
    per-(group, output-channel) scales: ``w`` (..., H, O) ->
    ``{"w": int8 (..., H/2, O), "scale": fp32 (..., G, O)}``, G = H / group.

    ``group`` is a cap: each tensor takes the largest even divisor of its
    own contraction dim up to it. Byte r of group g holds row ``g·group + r``
    in its low nibble, stored biased +8 (1..15), and row
    ``g·group + group/2 + r`` in its high nibble, signed. Same bytes and
    scales as the JAX package's eager ``quantize_weight_int4``."""
    *lead, h, o = w.shape
    group = default_int4_group(h, group or INT4_GROUP)
    g, half = h // group, group // 2
    wg = w.float().reshape(*lead, g, group, o)
    absmax = wg.abs().amax(dim=-2)  # (..., G, O)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / INT4_MAX)
    q = torch.round(wg / scale[..., None, :]).clamp(-INT4_MAX, INT4_MAX).to(torch.int8)
    lo, hi = q[..., :half, :], q[..., half:, :]
    packed = ((lo + 8) & 0x0F) | (hi << 4)  # int8 arithmetic wraps as in JAX
    return {"w": packed.reshape(*lead, h // 2, o), "scale": scale}


def unpack_int4(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int32 nibbles of packed int8 bytes (exact)."""
    p = packed.to(torch.int32)
    return (p & 15) - 8, p >> 4  # arithmetic shift: the byte's sign is in bit 7


def is_int4_weight(wq) -> bool:
    """int8 / fp8 weights carry (..., O) scales; int4 carries (..., G, O),
    the same rank as its packed payload. That rank difference is the format
    tag."""
    return isinstance(wq, dict) and "w" in wq and wq["scale"].dim() == wq["w"].dim()


def dequantize_weight_int4(wq: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Unpack and dequantize -> (..., H, O)."""
    packed, scale = wq["w"], wq["scale"]
    *lead, hp, o = packed.shape
    g = scale.shape[-2]
    lo, hi = unpack_int4(packed.reshape(*lead, g, hp // g, o))
    w = torch.cat([lo, hi], dim=-2).float() * scale[..., None, :]
    return w.reshape(*lead, 2 * hp, o).to(dtype)


def quantize_value(
    x: torch.Tensor, scales: torch.Tensor, mode: QuantMode, head_axis: int = 1
) -> torch.Tensor:
    """Quantize new K/V rows against EXISTING per-head scales."""
    if mode == "none":
        return x
    inv = 1.0 / _scale_shape(x.dim(), head_axis, scales)
    scaled = x.float() * inv
    if mode == "int8":
        return torch.round(scaled).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    if mode == "fp8":
        return _to_fp8(scaled)
    raise ValueError(f"unknown quant mode {mode!r}")
