"""Symmetric INT8 / FP8 (e4m3) quantization — twin of the JAX ``core/quant.py``.

Weights get per-output-channel scales (``quantize_weight``); KV rows are
quantized against fixed per-head cache scales (``quantize_value``).
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
    ``dequant = w_q * scale[..., None, :]``. Returns ``{"w", "scale"}``."""
    if mode == "int4":
        raise NotImplementedError(
            "int4 weights are not ported yet (ROADMAP Queue 1 item 10, kernel K6)"
        )
    if mode not in ("int8", "fp8"):
        raise ValueError("quantize_weight requires int8 or fp8")
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
    return (wq["w"].float() * wq["scale"][..., None, :]).to(dtype)


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
